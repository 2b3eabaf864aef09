"""Solve loop `rbcd`: the team's distributed solve through the SPMD engine.

One solve is one call of `spmd.make_run_fn(problem, cfg, mesh=None)`'s run
from the lifted chordal initialization to the traffic's stop rule (global
Riemannian gradnorm below `tol` at the start of a round) or its round cap,
and ends when the final iterate, the round count and the metrics are on the
host. Chordal initialization runs once, in set-up, as the upstream
`MultiRobotExample` computes it once before the team starts.

The team is `agents` robots owning contiguous pose ranges (pose k belongs
to robot k // (n // agents), the last robot takes the remainder, as in
`MultiRobotExample`). Each robot's local trust-region step stops at
`tol / (2 sqrt(agents))`, the example's local tolerance.
"""

from __future__ import annotations

import numpy as np


def contiguous_ranges(n: int, agents: int):
    """[start, end) pose ranges of the robots."""
    per = n // agents
    return [(a * per, (a + 1) * per if a < agents - 1 else n)
            for a in range(agents)]


class Solver:
    def __init__(self, edges, world, config, traffic, lift, dtype):
        import jax
        import jax.numpy as jnp

        from dpgo_tpu.parallel import spmd
        from dpgo_tpu.solvers import chordal

        self._jax = jax
        agents, r = int(config["agents"]), int(config["r"])
        tol = float(traffic["tol"])
        self.tol = tol
        self.max_rounds = int(traffic["max_rounds"])
        jdtype = jnp.dtype(dtype)

        T = np.asarray(chordal.chordal_initialization_arrays(
            edges, n=world.n, dtype=jdtype, tol=1e-10))
        X0 = np.einsum("rd,nde->nre", lift, T.astype(np.float64))
        problem, ranges = spmd.build_spmd_problem(
            edges.to_measurements(), world.n, agents, r, dtype=jdtype)
        expected = contiguous_ranges(world.n, agents)
        if [tuple(x) for x in ranges] != expected:
            raise RuntimeError(f"partition {ranges} is not the contiguous "
                               f"one {expected}")
        self.ranges = expected
        self.n = world.n
        cfg = spmd.SPMDConfig(
            mode=traffic["mode"],
            acceleration=bool(traffic["acceleration"]),
            adaptive_restart=bool(traffic["adaptive_restart"]),
            rtr_iterations=int(traffic["rtr_iterations"]),
            rtr_gradnorm_tol=tol / (2.0 * np.sqrt(agents)),
        )
        self.problem = problem
        self.run = spmd.make_run_fn(problem, cfg, mesh=None)
        self.state0 = spmd.initial_state(problem, X0.astype(jdtype), ranges)
        nb = problem.num_band
        self.counts = {
            "poses": world.n, "edges": world.m, "agents": agents,
            "band_offsets": list(problem.band_offsets),
            "gather_path_edges": int(np.sum(
                np.asarray(problem.priv_weight)[:, nb:] > 0)),
            "shared_edge_copies": int(np.sum(
                np.asarray(problem.shared_kappa) > 0)),
        }

    def warmup(self):
        """One round through the window's program (the round cap is a run-
        time argument, so this is the same compiled program)."""
        state, metrics, rounds = self.run(self.state0, 1, self.tol)
        self._jax.block_until_ready((state, metrics, rounds))

    def dispatch(self):
        return self.run(self.state0, self.max_rounds, self.tol)

    def readback(self, handle):
        state, metrics, rounds = handle
        X = np.asarray(state.X)
        rounds = int(rounds)
        # the loop stops on the round-start gradnorm, or at the round cap
        capped = float(metrics.gradnorm) >= self.tol
        out = np.zeros((self.n,) + X.shape[2:], X.dtype)
        for a, (s, e) in enumerate(self.ranges):
            out[s:e] = X[a, : e - s]
        return {"X": out, "rounds": rounds, "capped": capped,
                "_stacked": X}

    def device_metrics(self, record):
        """The program's own (cost, gradnorm) at the iterate read back: a
        forced-restart round of the same program starts from Y = X and
        reports its round-start metrics."""
        import jax.numpy as jnp

        X = jnp.asarray(record["_stacked"])
        state = self.state0._replace(
            X=X, Y=X, V=X, gamma=jnp.zeros_like(self.state0.gamma),
            do_restart=jnp.asarray(True))
        _, metrics, _ = self.run(state, 1, 0.0)
        return float(metrics.cost), float(metrics.gradnorm)


def prepare(edges, world, config, traffic, lift, dtype="float64"):
    return Solver(edges, world, config, traffic, lift, dtype)
