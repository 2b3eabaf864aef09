#!/usr/bin/env python
"""city10000 distributed-tail evidence (VERDICT r2 #3).

Runs BOTH schedules in f64 on CPU and records (cost, gradnorm) traces:
  A. the reference example's exact schedule — sequential greedy single-agent
     RBCD with Nesterov acceleration, stop at global gradnorm < 0.1
     (/root/reference/examples/MultiRobotExample.cpp:170-247) — via the
     in-process protocol path (parallel/simulation.py);
  B. the SPMD 'all'-mode (Jacobi-parallel) schedule with adaptive restart —
     the bench configuration.

Writes docs/city_tail.json. Usage:
  JAX_PLATFORMS=cpu python scripts/city_tail_experiment.py [iters]
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from dpgo_tpu import quadratic
from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel import spmd
from dpgo_tpu.parallel.simulation import (
    build_central_evaluation,
    run_synchronous_rbcd,
)
from dpgo_tpu.solvers.pgo import chordal_initialization
from dpgo_tpu.types import PGOAgentParameters, ROptParameters


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    meas, n = read_g2o_file("/root/reference/data/city10000.g2o")
    d, r, agents = 2, 3, 5
    tol = 0.1
    out = {}

    # B. SPMD 'all' (Jacobi) + Nesterov + adaptive restart, f64
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=agents, r=r)
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state = spmd.initial_state(problem, X0, ranges)
    qd_central = build_central_evaluation(meas, n, r)
    cfg = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=tol / (2 * np.sqrt(agents)),
        adaptive_restart=True,
    )
    run = spmd.make_run_fn(problem, cfg, mesh=None)
    t0 = time.perf_counter()
    trace_b = []
    s = state
    total = 0
    while total < iters:
        s, m, rds = run(s, 25, tol)
        total += int(rds)
        Xg = spmd.assemble_global(s, ranges, n)
        g64 = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(Xg)))
        c64 = 2 * float(quadratic.cost(qd_central, jnp.asarray(Xg)))
        trace_b.append({"round": total, "gradnorm": g64, "cost": c64})
        print(f"SPMD-all round {total}: gradnorm={g64:.4f} cost={c64:.2f}",
              flush=True)
        if g64 < tol:
            break
    out["spmd_all_f64"] = {
        "trace": trace_b, "elapsed_s": round(time.perf_counter() - t0, 1),
        "rounds": total,
    }

    # A. reference-exact schedule: sequential greedy + acceleration
    params = PGOAgentParameters(
        d=d, r=r, num_robots=agents,
        acceleration=True,
        local_opt_params=ROptParameters(RTR_iterations=1),
    )
    t0 = time.perf_counter()
    res = run_synchronous_rbcd(
        meas, n, num_robots=agents, params=params, num_iters=iters,
        gradnorm_tol=tol, selection="greedy", verbose=False,
    )
    out["reference_greedy_sequential"] = {
        "iterations": res.iterations,
        "final_cost": res.final_cost,
        "final_gradnorm": res.final_gradnorm,
        "elapsed_s": round(time.perf_counter() - t0, 1),
        "cost_trace": res.cost_trace[::10],
        "gradnorm_trace": res.gradnorm_trace[::10],
    }
    print(f"reference schedule: {res.iterations} iters, "
          f"gradnorm={res.final_gradnorm:.4f} cost={res.final_cost:.2f}")

    path = os.path.join(_REPO, "docs", "city_tail.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
