#!/usr/bin/env python
"""Chunked wall-clock tuning of the 100k certified delta engine's knobs
(tCG inner budget, tCG matmul precision, chunk size). Each measurement is a
real 25-round device-resident chunk timed by a host-materialized scalar.

Usage: python scripts/tune_delta.py [num_poses] [knob=val ...]
e.g.   python scripts/tune_delta.py 100000 tcg=50 tcg=20 tcg=10
"""

import dataclasses as dc
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import numpy as np


def main():
    num_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    tcg_values = [int(a.split("=")[1]) for a in sys.argv[2:]
                  if a.startswith("tcg=")] or [50, 20, 10]
    num_agents = 10
    seed = 1

    import jax
    import jax.numpy as jnp

    from dpgo_tpu.datasets import synthesize_grid3d
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import delta as delta_mod
    from dpgo_tpu.parallel import spmd

    edges, n, T_true = synthesize_grid3d(num_poses, seed=seed)
    meas = edges.to_measurements()
    coords = np.asarray(T_true)[:, :, 3].round().astype(np.int64)
    order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)
    meas = [dc.replace(m, p1=int(new_of_old[m.p1]), p2=int(new_of_old[m.p2]))
            for m in meas]
    problem, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=num_agents, r=5, dtype=jnp.float32
    )
    from dpgo_tpu.solvers import chordal as chordal_mod

    T = np.asarray(chordal_mod.chordal_initialization_arrays(edges, n=n))
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, 5))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)[order]
    state = spmd.initial_state(problem, X0, ranges)
    base = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)),
        adaptive_restart=True, rtr_residual_control=True,
        rtr_inner_control_matvecs=False, rtr_tcg_precision="high",
    )
    for it in tcg_values:
        c = dc.replace(base, rtr_tcg_iterations=it)
        run = delta_mod.make_delta_run_fn(problem, c, None, reanchor_every=25)
        ref = delta_mod.build_delta_ref(problem, np.asarray(state.X, np.float64))
        st = delta_mod.initial_delta_state(ref)
        st, ref, m, r = run(ref, st, 25, 1e-9)  # compile + warm chunk
        float(m.gradnorm)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            st, ref, m, r = run(ref, st, 25, 1e-9)
            float(m.gradnorm)
            times.append(time.perf_counter() - t0)
        best = min(times) / 25 * 1000
        print(f"tcg_iters={it}: {best:.0f} ms/round (chunks "
              f"{' '.join(f'{t:.1f}s' for t in times)}) "
              f"gn@75={float(m.gradnorm):.4f}", flush=True)


if __name__ == "__main__":
    main()
