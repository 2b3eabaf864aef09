"""Faults planted under the timed path, for the tests that `correct`
comes out false on a broken program. Each is a function of pytest's
`monkeypatch` that breaks one program entry the solve loops call; the
harness itself is left as it is."""

import jax.numpy as jnp

from dpgo_tpu import quadratic
from dpgo_tpu.parallel import spmd
from dpgo_tpu.solvers import rtr


def rbcd_state_unchanged(mp):
    """The run returns the state it was given, with the real metrics."""
    real = spmd.make_run_fn

    def make_run_fn(problem, cfg, mesh=None):
        run = real(problem, cfg, mesh)

        def broken(state, max_rounds, tol, **kw):
            _, metrics, rounds = run(state, max_rounds, tol, **kw)
            return state, metrics, rounds
        return broken
    mp.setattr(spmd, "make_run_fn", make_run_fn)


def rbcd_half_the_edges(mp):
    """The team solves on every other measurement: half the batch left
    out, the objective summed over the rest."""
    real = spmd.build_spmd_problem

    def build(measurements, num_poses, num_agents, r, dtype=jnp.float64):
        return real(measurements[::2], num_poses, num_agents, r, dtype)
    mp.setattr(spmd, "build_spmd_problem", build)


def rbcd_no_exchange(mp):
    """The exchange of public poses between agents delivers zeros."""
    real = spmd._gather_pub

    def gather(X_blk, pub_idx_blk, axis_name):
        return jnp.zeros_like(real(X_blk, pub_idx_blk, axis_name))
    mp.setattr(spmd, "_gather_pub", gather)


def rbcd_answer_altered(mp):
    """One translation of the returned iterate is moved by 1."""
    real = spmd.make_run_fn

    def make_run_fn(problem, cfg, mesh=None):
        run = real(problem, cfg, mesh)

        def broken(state, max_rounds, tol, **kw):
            state, metrics, rounds = run(state, max_rounds, tol, **kw)
            return (state._replace(X=state.X.at[0, 5, 0, -1].add(1.0)),
                    metrics, rounds)
        return broken
    mp.setattr(spmd, "make_run_fn", make_run_fn)


def central_state_unchanged(mp):
    """The solve returns its starting iterate, with the real statistics."""
    real = rtr.rtr_solve_auto

    def solve(problem, X0, *args, **kw):
        _, stats = real(problem, X0, *args, **kw)
        return X0, stats
    mp.setattr(rtr, "rtr_solve_auto", solve)


def central_half_the_edges(mp):
    """The solver's problem holds every other measurement."""
    real = quadratic.from_private_measurements

    def build(edges, n, d, dtype=jnp.float64, band=True):
        import dataclasses

        half = dataclasses.replace(edges, **{
            f.name: getattr(edges, f.name)[::2]
            for f in dataclasses.fields(edges)})
        return real(half, n, d, dtype=dtype, band=band)
    mp.setattr(quadratic, "from_private_measurements", build)


def central_answer_altered(mp):
    """One translation of the returned iterate is moved by 1."""
    real = rtr.rtr_solve_auto

    def solve(problem, X0, *args, **kw):
        X, stats = real(problem, X0, *args, **kw)
        return X.at[5, 0, -1].add(1.0), stats
    mp.setattr(rtr, "rtr_solve_auto", solve)


FAULTS = {
    "tiny-city.rbcd": {
        "state_unchanged": rbcd_state_unchanged,
        "half_the_edges": rbcd_half_the_edges,
        "no_exchange": rbcd_no_exchange,
        "answer_altered": rbcd_answer_altered,
    },
    # one robot: there is no exchange to leave out
    "tiny-grid.central": {
        "state_unchanged": central_state_unchanged,
        "half_the_edges": central_half_the_edges,
        "answer_altered": central_answer_altered,
    },
}
