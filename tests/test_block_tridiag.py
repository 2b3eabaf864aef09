"""Cyclic-reduction block-tridiagonal solver (ops/block_tridiag.py) — the
batched replacement for the reference's Cholmod LDL^T preconditioner
(reference: src/PoseGraph.cpp:598-613)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dpgo_tpu.ops import block_tridiag as bt


def _random_spd_block_tridiag(rng, n, b):
    """Dense SPD block-tridiagonal matrix + its (D, E) block form."""
    A = np.zeros((n * b, n * b))
    for i in range(n):
        M = rng.standard_normal((b, b))
        A[i * b:(i + 1) * b, i * b:(i + 1) * b] = M @ M.T + 5 * np.eye(b)
    E = rng.standard_normal((max(n - 1, 0), b, b)) * 0.5
    for i in range(n - 1):
        A[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = -E[i]
        A[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = -E[i].T
    A += np.eye(n * b) * 2.0
    D = np.stack([A[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(n)])
    return A, D, E


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 100, 257])
def test_cyclic_reduction_matches_dense_solve(n):
    rng = np.random.default_rng(0)
    b = 4
    A, D, E = _random_spd_block_tridiag(rng, n, b)
    rhs = rng.standard_normal((n, b, 3))
    f = bt.factorize(jnp.asarray(D), jnp.asarray(E))
    x = np.asarray(bt.solve(f, jnp.asarray(rhs)))
    x_ref = np.linalg.solve(A, rhs.reshape(n * b, 3)).reshape(n, b, 3)
    err = np.abs(x - x_ref).max() / (np.abs(x_ref).max() + 1e-300)
    assert err < 1e-9, f"n={n}: rel err {err}"


def test_tridiag_preconditioner_in_quadratic_data():
    """precond='tridiag' applies the exact inverse of the band-tridiagonal
    truncation of (Q + 0.1 I), post-composed with the tangent projection."""
    from dpgo_tpu import quadratic
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.solvers.averaging import project_to_rotation_group

    rng = np.random.default_rng(1)
    n, d, r = 6, 3, 5
    dh = d + 1

    def rT():
        T = np.eye(dh)
        T[:d, :d] = project_to_rotation_group(rng.standard_normal((d, d)))
        T[:d, d] = rng.standard_normal(d)
        return T

    lp = quadratic.make_local_problem(
        n=n, d=d,
        priv_i=list(range(n - 1)) + [0],
        priv_j=list(range(1, n)) + [3],
        priv_T=[rT() for _ in range(n)],
        priv_kappa=[2.0] * n, priv_tau=[1.0] * n, priv_weight=[1.0] * n,
        r=r,
    )
    lp = quadratic.plan_bands(lp, offsets=(1,))
    qd = quadratic.build_quadratic_data(
        lp, jnp.zeros((1, r, dh)), r=r, precond="tridiag"
    )
    assert qd.btf is not None

    # dense reference of the band-tridiagonal part
    M = np.zeros((n * dh, n * dh))
    dg = np.asarray(qd.diag) + 0.1 * np.eye(dh)
    bE = np.asarray(qd.band_E)[0]  # offset-1 lane
    for i in range(n):
        M[i * dh:(i + 1) * dh, i * dh:(i + 1) * dh] = dg[i]
    for i in range(n - 1):
        M[i * dh:(i + 1) * dh, (i + 1) * dh:(i + 2) * dh] = -bE[i]
        M[(i + 1) * dh:(i + 2) * dh, i * dh:(i + 1) * dh] = -bE[i].T
    X = jnp.asarray(rng.standard_normal((n, r, dh)))
    V = jnp.asarray(rng.standard_normal((n, r, dh)))
    out = np.asarray(quadratic.apply_precond(qd, X, V))
    sol = np.linalg.solve(
        M, np.asarray(V).transpose(0, 2, 1).reshape(n * dh, r)
    ).reshape(n, dh, r).transpose(0, 2, 1)
    ref = np.asarray(lifted.proj_tangent(X, jnp.asarray(sol)))
    np.testing.assert_allclose(out, ref, atol=1e-10)


def test_banded_factor_is_exact_inverse():
    """BandedFactor (RCM relabel + superblock cyclic reduction) applies the
    EXACT (Q + 0.1 I)^{-1} — Cholmod-LDL^T parity with the reference's full
    sparse factorization (PoseGraph.cpp:598-613) on a real 2D dataset with
    long-range loop closures."""
    from dpgo_tpu import quadratic
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.measurements import EdgeArrays

    ms, n = read_g2o_file("/root/reference/data/input_MITb_g2o.g2o")
    d = ms[0].d
    r = 5
    edges = EdgeArrays.from_measurements(ms)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    qd = quadratic.build_q_data(problem, r=r, precond="banded")
    assert isinstance(qd.btf, bt.BandedFactor)
    # original labeling is far from banded; RCM collapses it
    assert qd.btf.s < 64

    rng = np.random.default_rng(0)
    V = jnp.asarray(rng.standard_normal((n, r, d + 1)))
    out = bt.solve_banded(qd.btf, V)
    back = quadratic.q_matvec(qd, out) + 0.1 * out
    err = float(jnp.linalg.norm(back - V) / jnp.linalg.norm(V))
    assert err < 1e-10, err


def test_banded_plan_drops_nothing_at_full_bandwidth():
    from dpgo_tpu import quadratic
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.measurements import EdgeArrays

    ms, n = read_g2o_file("/root/reference/data/CSAIL.g2o")
    edges = EdgeArrays.from_measurements(ms)
    problem = quadratic.from_private_measurements(edges, n=n, d=2)
    plan = bt.make_banded_plan(
        np.asarray(problem.priv_i), np.asarray(problem.priv_j), n, 3
    )
    assert plan is not None
    assert plan.dropped == 0
    assert plan.s >= plan.bandwidth
