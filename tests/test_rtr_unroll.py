"""Unrolled-tCG parity: small static caps run masked-unrolled (rtr._TCG_UNROLL)
instead of lax.while_loop — the fast path for the tiny-block delta rounds
(city2d tcg cap 3) where while_loop iteration boundaries are fusion
barriers. These tests pin the two paths to the same
trajectory: identical iteration counts / boundary flags, and eta/Heta equal
to ~1 ulp (XLA may re-fuse across the unrolled steps; the operations and
their order are otherwise identical)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu import quadratic
from dpgo_tpu.measurements import EdgeArrays
from dpgo_tpu.ops import lifted
from dpgo_tpu.solvers import chordal as chordal_mod
from dpgo_tpu.solvers import rtr as rtr_mod


@pytest.fixture(scope="module")
def tcg_inputs(small_grid):
    meas, n = small_grid
    d, r = meas[0].d, 5
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    T = chordal_mod.chordal_initialization_arrays(edges, n=n)
    Y = jnp.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = jnp.einsum("rd,nde->nre", Y, T)
    qd = quadratic.build_quadratic_data(
        problem, jnp.zeros((1, r, d + 1)), r=r, precond="jacobi"
    )
    eg = quadratic.q_matvec(qd, X0) + qd.G
    grad = lifted.proj_tangent(X0, eg)
    S = quadratic.hess_correction(X0, eg)
    return qd, X0, S, grad


@pytest.mark.parametrize(
    "radius, max_inner",
    [
        (1.0, 3),     # boundary hit on iteration 1 -> 2 masked (frozen) steps
        (1e-4, 3),    # immediate boundary: every later step discarded
        (1e6, 3),     # no boundary: all 3 steps live
        (1e6, 4),     # at the unroll threshold
    ],
)
def test_unrolled_tcg_matches_while_loop(tcg_inputs, radius, max_inner):
    qd, X0, S, grad = tcg_inputs
    rad = jnp.asarray(radius, X0.dtype)
    saved = rtr_mod._TCG_UNROLL
    try:
        rtr_mod._TCG_UNROLL = 4
        a = rtr_mod._tcg(qd, X0, S, grad, rad, max_inner)
        rtr_mod._TCG_UNROLL = 0  # force the while_loop path
        b = rtr_mod._tcg(qd, X0, S, grad, rad, max_inner)
    finally:
        rtr_mod._TCG_UNROLL = saved
    assert int(a.num_iters) == int(b.num_iters)
    assert bool(a.hit_boundary) == bool(b.hit_boundary)
    assert bool(jnp.all(jnp.isfinite(a.eta)))
    scale = float(jnp.max(jnp.abs(b.eta))) or 1.0
    np.testing.assert_allclose(
        np.asarray(a.eta), np.asarray(b.eta), rtol=0, atol=8e-15 * scale
    )
    hscale = float(jnp.max(jnp.abs(b.Heta))) or 1.0
    np.testing.assert_allclose(
        np.asarray(a.Heta), np.asarray(b.Heta), rtol=0, atol=8e-15 * hscale
    )
