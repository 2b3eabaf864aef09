#!/usr/bin/env python
"""SPMD example: the whole multi-agent optimization as one XLA
program over a device mesh.

Usage: python examples/spmd_example.py [# agents] [input .g2o file] [mode]

mode: all (parallel block updates, default) | greedy | uniform | async
(semantic-async: Poisson-thinned per-agent updates; acceleration off).
With multiple devices the agents shard over the mesh and public-pose
exchange is an all_gather over the mesh; on one device the same program runs fully batched.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    if len(sys.argv) < 3:
        print(f"Usage: {sys.argv[0]} [# agents] [input .g2o file] [mode]")
        sys.exit(1)
    num_agents = int(sys.argv[1])
    path = sys.argv[2]
    mode = sys.argv[3] if len(sys.argv) > 3 else "all"

    import jax
    from jax.sharding import Mesh

    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    meas, n = read_g2o_file(path)
    d, r = meas[0].d, 5
    print(f"{len(meas)} measurements, {n} poses, {num_agents} agents, mode={mode}")

    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=num_agents, r=r)
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state = spmd.initial_state(problem, X0, ranges)

    devices = jax.devices()
    mesh = None
    if len(devices) > 1 and num_agents % len(devices) == 0:
        mesh = Mesh(np.array(devices), ("agents",))
        print(f"sharding agents over {len(devices)} devices")

    cfg = spmd.SPMDConfig(mode=mode, acceleration=(mode != "async"),
                          rtr_iterations=1,
                          rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)))
    run = spmd.make_run_fn(problem, cfg, mesh=mesh)
    total, g = 0, float("inf")
    while total < 1000 and g >= 0.1:
        state, metrics, rounds = run(state, 50, 0.1)
        total += int(rounds)
        g = float(metrics.gradnorm)
        print(f"round {total}: cost={float(metrics.cost):.4f} gradnorm={g:.4f}")
    X = spmd.assemble_global(state, ranges, n)
    print(f"done in {total} rounds; solution shape {X.shape}")


if __name__ == "__main__":
    main()
