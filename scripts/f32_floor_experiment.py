#!/usr/bin/env python
"""Measure the f32-state gradnorm floor: converge grid3d in f64 (CPU),
quantize the iterate to f32, and evaluate the true f64 global Riemannian
gradient norm at the quantized point.

This decides the design of the 100k certified path: if the floor at the
target scale is < 1e-2, a pure-f32-state device program can place the iterate
well enough for f64 certification; otherwise a compensated (delta-state)
representation is required.

Usage: python scripts/f32_floor_experiment.py [num_poses] [num_agents] [max_rounds]
"""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def main():
    num_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    num_agents = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    max_rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 600

    import jax
    import jax.numpy as jnp

    from dpgo_tpu import quadratic
    from dpgo_tpu.datasets import synthesize_grid3d
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.parallel.simulation import build_central_evaluation
    from dpgo_tpu.solvers import chordal as chordal_mod

    r = 5
    edges, n, T_true = synthesize_grid3d(num_poses, seed=1)
    meas = edges.to_measurements()
    T = np.asarray(chordal_mod.chordal_initialization_arrays(edges, n=n))

    # raster relabeling (same as scale_bench)
    coords = np.asarray(T_true)[:, :, 3].round().astype(np.int64)
    order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)
    import dataclasses as _dc

    meas = [
        _dc.replace(m, p1=int(new_of_old[m.p1]), p2=int(new_of_old[m.p2]))
        for m in meas
    ]

    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=num_agents, r=r)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)[order]
    state = spmd.initial_state(problem, X0, ranges)
    cfg = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)),
    )
    run = spmd.make_run_fn(problem, cfg, mesh=None)
    t0 = time.perf_counter()
    total = 0
    gn = float("inf")
    while total < max_rounds and gn >= 1e-3:
        state, metrics, rounds = run(state, 50, 1e-3)
        total += int(rounds)
        gn = float(metrics.gradnorm)
        print(f"  round {total}: gradnorm={gn:.5f} cost={float(metrics.cost):.1f}",
              flush=True)
    dt = time.perf_counter() - t0
    print(f"converged-ish: {total} rounds, {dt:.1f}s, gradnorm={gn:.5f}")

    qd_central = build_central_evaluation(meas, n, r)
    X = spmd.assemble_global(state, ranges, n)
    g64 = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(X)))
    X32 = X.astype(np.float32).astype(np.float64)
    g32 = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(X32)))
    # translation extent (drives the quantization floor)
    p = X[:, :, -1]
    print(
        f"n={num_poses}: f64 gradnorm at iterate = {g64:.6f}; after f32 "
        f"quantization = {g32:.6f}; floor contribution = "
        f"{np.sqrt(max(g32**2 - g64**2, 0.0)):.6f}; "
        f"translation extent max|p| = {np.abs(p).max():.1f}"
    )


if __name__ == "__main__":
    main()
