"""Solve loop `central`: the single-robot certifiable path.

One solve is chordal initialization (`chordal.chordal_initialization_arrays`)
from the measurements, the lift by the run's Stiefel matrix, and
`rtr.rtr_solve_auto` to the traffic's gradnorm tolerance; it ends when the
iterate and the solver's statistics are on the host. The problem (the
measurements packed into the solver's edge arrays, with band lanes planned)
is built once, in set-up.
"""

from __future__ import annotations

import numpy as np


class Solver:
    def __init__(self, edges, world, config, traffic, lift, dtype):
        import jax
        import jax.numpy as jnp

        from dpgo_tpu import quadratic
        from dpgo_tpu.solvers import chordal, rtr

        self._jax = jax
        self._chordal = chordal
        self._rtr = rtr
        self.d, self.n = world.d, world.n
        self.dtype = jnp.dtype(dtype)
        self.edges = edges
        self.traffic = traffic
        self.tol = float(traffic["tol"])
        self.problem = quadratic.from_private_measurements(
            edges, n=world.n, d=world.d, dtype=self.dtype)
        self.lift = jnp.asarray(lift, self.dtype)
        self.counts = {
            "poses": world.n, "edges": world.m,
            "band_offsets": list(self.problem.band_offsets),
            "gather_path_edges": world.m - int(self.problem.num_band),
        }

    def warmup(self):
        """One whole solve: chordal's programs, the probe solve and, where
        the probe stalls, the banded one, all at the window's shapes."""
        self.readback(self.dispatch())

    def dispatch(self):
        jnp = self._jax.numpy
        T = self._chordal.chordal_initialization_arrays(
            self.edges, n=self.n, dtype=self.dtype, tol=1e-10)
        X0 = jnp.einsum("rd,nde->nre", self.lift, T)
        t = self.traffic
        return self._rtr.rtr_solve_auto(
            self.problem, X0, gradnorm_tol=self.tol,
            initial_radius=float(t["initial_radius"]),
            max_iterations=int(t["max_iterations"]),
            max_inner=int(t["max_inner"]),
        )

    def readback(self, handle):
        X, stats = handle
        X = np.asarray(X)
        stats = self._jax.tree.map(np.asarray, stats)
        gradnorm = float(stats.gnorm_opt)
        return {
            "X": X, "rtr_iters": int(stats.iterations),
            "tcg_iters": int(stats.tcg_iters),
            "capped": gradnorm >= self.tol,
            "_device": (2.0 * float(stats.f_opt), gradnorm),
        }

    def device_metrics(self, record):
        """The solver's own (cost, gradnorm) at its returned iterate; its
        objective is cost / 2."""
        return record["_device"]


def prepare(edges, world, config, traffic, lift, dtype="float64"):
    return Solver(edges, world, config, traffic, lift, dtype)
