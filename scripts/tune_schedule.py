#!/usr/bin/env python
"""Rounds-to-tolerance sweep of the delta engine's acceleration schedule.

The certified 100k wall time is rounds x round-cost; tune_delta.py maps the
round-cost knobs (tCG budget, precision), this script maps the ROUNDS knobs:
Nesterov team size `nesterov_n` (the reference's gamma/alpha recursions use
the robot count N — the right schedule when ONE block updates per round, but
mode='all' updates every block every round, where a smaller effective N is
admissible), the periodic `restart_interval`, and the tCG budget's effect on
rounds (cheap rounds may need more of them). Runs the delta engine only
(phase 2 of the certified pipeline — it dominates: 686/686 rounds at 100k),
from the same chordal init, stopping at device gradnorm < 0.9e-2 exactly
like run_delta_certified. Size-transferable in direction, not in constant:
verify the winner at 100k on the device.

Usage: python scripts/tune_schedule.py [num_poses] [cfg ...]
  cfg = restart:nesterov_n:tcg  (nesterov_n empty = num_agents)
e.g.   python scripts/tune_schedule.py 10000 30::50 30::20 30:3:20 30:1:20
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
    num_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    cfg_specs = sys.argv[2:] or ["30::50", "30::20", "1000000::20",
                                 "30:3:20", "30:1:20", "60::20"]
    num_agents = 10
    seed = 1
    tol = float(os.environ.get("DPGO_SCALE_TOL", "1e-2"))
    max_rounds = int(os.environ.get("DPGO_TUNE_MAX_ROUNDS", "1500"))
    chunk = int(os.environ.get("DPGO_SCALE_CHUNK", "25"))

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
    X0_64 = np.einsum("rd,nde->nre", Y_lift, T)[order].astype(np.float64)
    state0 = spmd.initial_state(problem, X0_64, ranges)
    X_base = np.asarray(state0.X, np.float64)
    base = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)),
        adaptive_restart=True, rtr_residual_control=True,
        rtr_inner_control_matvecs=False, rtr_tcg_precision="high",
    )
    for spec in cfg_specs:
        ri_s, nn_s, tcg_s = spec.split(":")
        c = dc.replace(
            base,
            restart_interval=int(ri_s) if ri_s else 30,
            nesterov_n=int(nn_s) if nn_s else None,
            rtr_tcg_iterations=int(tcg_s) if tcg_s else 50,
        )
        run = delta_mod.make_delta_run_fn(problem, c, None, reanchor_every=25)
        ref = delta_mod.build_delta_ref(problem, X_base)
        st = delta_mod.initial_delta_state(ref)
        total, gn = 0, float("inf")
        t0 = time.perf_counter()
        while total < max_rounds and gn >= 0.9 * tol:
            st, ref, m, rr = run(ref, st, min(chunk, max_rounds - total),
                                 0.9 * tol)
            total += int(rr)
            gn = float(m.gradnorm)
        wall = time.perf_counter() - t0
        print(f"restart={ri_s or 30} nesterov_n={nn_s or 'N'} "
              f"tcg={tcg_s or 50}: rounds={total} gn={gn:.4f} "
              f"wall={wall:.1f}s ({1000*wall/max(total,1):.0f} ms/round)",
              flush=True)


if __name__ == "__main__":
    main()
