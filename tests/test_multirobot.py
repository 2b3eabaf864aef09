"""Multi-robot in-process simulation tests (tier 3: the reference's
MultiRobotExample flow on a partitioned dataset)."""

import numpy as np
import pytest

from dpgo_tpu.parallel.simulation import run_synchronous_rbcd
from dpgo_tpu.types import PGOAgentParameters, ROptParameters


def _params(num_robots, accel):
    return PGOAgentParameters(
        d=3,
        r=5,
        num_robots=num_robots,
        acceleration=accel,
        local_opt_params=ROptParameters(RTR_iterations=1),
    )


def test_sync_rbcd_two_robots(tiny_grid):
    meas, n = tiny_grid
    res = run_synchronous_rbcd(
        meas, n, num_robots=2, params=_params(2, accel=False),
        num_iters=200, gradnorm_tol=0.1,
    )
    assert res.final_gradnorm < 0.1
    # cost decreases overall
    assert res.cost_trace[-1] < res.cost_trace[0]


def test_sync_rbcd_accelerated(tiny_grid):
    meas, n = tiny_grid
    res = run_synchronous_rbcd(
        meas, n, num_robots=3, params=_params(3, accel=True),
        num_iters=200, gradnorm_tol=0.1,
    )
    assert res.final_gradnorm < 0.1


def test_sync_rbcd_uniform_selection(tiny_grid):
    meas, n = tiny_grid
    res = run_synchronous_rbcd(
        meas, n, num_robots=2, params=_params(2, accel=False),
        num_iters=300, gradnorm_tol=0.1, selection="uniform",
    )
    assert res.final_gradnorm < 0.1


def test_sync_rbcd_matches_centralized_cost(tiny_grid):
    """Distributed RBCD must reach (approximately) the centralized solver's
    objective on the same lifted problem."""
    import jax.numpy as jnp

    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel.simulation import build_central_evaluation
    from dpgo_tpu.solvers import rtr as rtr_mod
    from dpgo_tpu.solvers.pgo import chordal_initialization

    meas, n = tiny_grid
    r = 5
    qd = build_central_evaluation(meas, n, r)
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = jnp.asarray(np.einsum("rd,nde->nre", Y_lift, T))
    X_star, stats = rtr_mod.rtr_solve(
        qd, X0, 1e-8, 100.0, max_iterations=300, max_inner=200
    )
    f_star = 2.0 * float(
        __import__("dpgo_tpu.quadratic", fromlist=["cost"]).cost(qd, X_star)
    )

    res = run_synchronous_rbcd(
        meas, n, num_robots=2, params=_params(2, accel=False),
        num_iters=400, gradnorm_tol=1e-3,
    )
    assert res.final_cost == pytest.approx(f_star, rel=1e-4)
