"""Lowering checks: the products that feed trust-region decisions in f32
carry HIGHEST precision, so a backend cannot run them in a reduced-precision
mode (TF32 on a GPU) whatever its default."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu import quadratic
from dpgo_tpu.measurements import EdgeArrays
from dpgo_tpu.parallel import delta as delta_mod
from dpgo_tpu.parallel import spmd
from dpgo_tpu.solvers import rtr as rtr_mod
from tests import oracle


def _dot_precisions(lowered_text):
    """(number of dot_general ops, number of them at HIGHEST/HIGHEST)."""
    lines = [ln for ln in lowered_text.splitlines()
             if "stablehlo.dot_general" in ln]
    highest = [ln for ln in lines if "precision = [HIGHEST, HIGHEST]" in ln]
    return len(lines), len(highest)


def _f32_residual_qd(n=12, d=3, r=5):
    rng = np.random.default_rng(7)
    meas, _ = oracle.random_measurements(rng, n, d, extra_lc=5)
    problem = quadratic.from_private_measurements(
        EdgeArrays.from_measurements(meas), n=n, d=d, dtype=jnp.float32,
    )
    nbr = jnp.zeros((1, r, d + 1), jnp.float32)
    qd = dataclasses.replace(
        quadratic.build_quadratic_data(problem, nbr, r=r),
        res=quadratic.build_residual_data(problem, nbr),
    )
    X = jnp.asarray(rng.standard_normal((n, r, d + 1)), jnp.float32)
    return qd, X


@pytest.mark.parametrize("path", ["initial_state", "iteration"])
def test_residual_control_products_are_highest(path):
    """The residual-control cost and gradient (rtr residual_control=True),
    the tangent projections and the inner products around them lower every
    dot_general at HIGHEST."""
    qd, X = _f32_residual_qd()

    def initial(qd, X):
        return rtr_mod.initial_cost_gradnorm(qd, X, residual_control=True)

    def iteration(qd, X):
        # with the tCG itself at HIGHEST, any control-path product that
        # ignored the precision would show as a DEFAULT dot
        return rtr_mod.rtr_solve(
            qd, X, 1e-6, 1.0, max_inner=3, shrink_until_accept=True,
            residual_control=True, tcg_precision=jax.lax.Precision.HIGHEST,
        )

    fn = initial if path == "initial_state" else iteration
    n_dot, n_hi = _dot_precisions(jax.jit(fn).lower(qd, X).as_text())
    assert n_dot > 0 and n_hi == n_dot


def test_delta_cost_grad_products_are_highest(tiny_grid):
    """The delta engine's residual-form cost/gradient (f32 state) lowers
    every dot_general at HIGHEST."""
    meas, n = tiny_grid
    problem, _ = spmd.build_spmd_problem(meas, n, num_agents=2, r=5,
                                         dtype=jnp.float32)
    om_p, om_s = delta_mod._omegas(problem)
    a = 0
    D = jnp.zeros((problem.n_max, 5, 4), jnp.float32)
    ms = problem.shared_idx.shape[1]
    mp = problem.priv_i.shape[1]

    def f(D):
        return delta_mod._delta_cost_grad(
            (jnp.zeros((mp, 5, 4), jnp.float32),
             jnp.zeros((ms, 5, 4), jnp.float32)),
            (problem.priv_i[a], problem.priv_j[a], problem.priv_T[a], om_p[a]),
            (problem.shared_idx[a], problem.shared_T[a], om_s[a],
             problem.shared_outgoing[a]),
            D, jnp.zeros((ms, 5, 4), jnp.float32),
        )

    n_dot, n_hi = _dot_precisions(jax.jit(f).lower(D).as_text())
    assert n_dot > 0 and n_hi == n_dot
