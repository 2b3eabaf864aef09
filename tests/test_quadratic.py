"""Quadratic-operator parity vs a dense numpy oracle of the reference math."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu import quadratic
from dpgo_tpu.measurements import EdgeArrays, homogeneous
from dpgo_tpu.ops import lifted
from tests import oracle


def _random_problem(rng, n=8, d=3, r=5, extra_lc=4):
    meas, _ = oracle.random_measurements(rng, n, d, extra_lc)
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    qd = quadratic.build_quadratic_data(problem, jnp.zeros((1, r, d + 1)), r=r)
    Qdense = oracle.dense_connection_laplacian(meas, n)
    return meas, qd, Qdense


def test_q_matvec_matches_dense():
    rng = np.random.default_rng(10)
    n, d, r = 8, 3, 5
    _, qd, Qdense = _random_problem(rng, n, d, r)
    V = rng.standard_normal((n, r, d + 1))
    out = np.asarray(quadratic.q_matvec(qd, jnp.asarray(V)))
    out_dense = oracle.unflat(oracle.flat(V) @ Qdense, n, d)
    np.testing.assert_allclose(out, out_dense, rtol=1e-12, atol=1e-10)


def test_cost_and_grad_match_dense():
    rng = np.random.default_rng(11)
    n, d, r = 10, 3, 5
    _, qd, Qdense = _random_problem(rng, n, d, r)
    X = rng.standard_normal((n, r, d + 1))
    G = np.zeros((r, (d + 1) * n))
    f = float(quadratic.cost(qd, jnp.asarray(X)))
    f_dense = oracle.dense_f(oracle.flat(X), Qdense, G)
    np.testing.assert_allclose(f, f_dense, rtol=1e-12)
    g = np.asarray(quadratic.euc_grad(qd, jnp.asarray(X)))
    g_dense = oracle.unflat(oracle.dense_euc_grad(oracle.flat(X), Qdense, G), n, d)
    np.testing.assert_allclose(g, g_dense, rtol=1e-12, atol=1e-10)


def test_q_2d():
    rng = np.random.default_rng(12)
    n, d, r = 6, 2, 3
    meas, _ = oracle.random_measurements(rng, n, d, 2)
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    qd = quadratic.build_quadratic_data(problem, jnp.zeros((1, r, d + 1)), r=r)
    Qdense = oracle.dense_connection_laplacian(meas, n)
    V = rng.standard_normal((n, r, d + 1))
    out = np.asarray(quadratic.q_matvec(qd, jnp.asarray(V)))
    np.testing.assert_allclose(
        out, oracle.unflat(oracle.flat(V) @ Qdense, n, d), rtol=1e-12, atol=1e-10
    )


def test_shared_edges_and_linear_term():
    """Shared-edge diagonal + G contributions vs a hand-built dense oracle
    following PoseGraph.cpp:381-580."""
    rng = np.random.default_rng(13)
    n, d, r = 5, 3, 5
    dh = d + 1
    meas, _ = oracle.random_measurements(rng, n, d, 2)
    edges = EdgeArrays.from_measurements(meas)

    # two shared edges: one outgoing (local pose 1 -> nbr), one incoming
    from dpgo_tpu.solvers.averaging import project_to_rotation_group

    def rand_T():
        R = project_to_rotation_group(rng.standard_normal((d, d)))
        t = rng.standard_normal(d)
        return R, t

    R1, t1 = rand_T()
    R2, t2 = rand_T()
    kap = [2.0, 3.0]
    tau = [1.5, 0.5]
    w = [0.7, 1.0]
    nbr_poses = rng.standard_normal((2, r, dh))

    problem = quadratic.make_local_problem(
        n=n, d=d,
        priv_i=edges.p1, priv_j=edges.p2,
        priv_T=homogeneous(edges.R, edges.t),
        priv_kappa=edges.kappa, priv_tau=edges.tau, priv_weight=edges.weight,
        shared_idx=[1, 3],
        shared_T=np.stack([homogeneous(R1, t1), homogeneous(R2, t2)]),
        shared_kappa=kap, shared_tau=tau, shared_weight=w,
        shared_outgoing=[True, False],
        shared_nbr_slot=[0, 1],
        shared_mask=[1.0, 1.0],
        r=r,
    )
    qd = quadratic.build_quadratic_data(problem, jnp.asarray(nbr_poses), r=r)

    # dense oracle
    Q = oracle.dense_connection_laplacian(meas, n)
    G = np.zeros((r, dh * n))
    for k, (R, t, idx, outgoing) in enumerate(
        [(R1, t1, 1, True), (R2, t2, 3, False)]
    ):
        T = np.zeros((dh, dh))
        T[:d, :d] = R
        T[:d, d] = t
        T[d, d] = 1.0
        Om = np.diag([w[k] * kap[k]] * d + [w[k] * tau[k]])
        if outgoing:
            Q[idx * dh : (idx + 1) * dh, idx * dh : (idx + 1) * dh] += T @ Om @ T.T
            G[:, idx * dh : (idx + 1) * dh] += -nbr_poses[k] @ Om @ T.T
        else:
            Q[idx * dh : (idx + 1) * dh, idx * dh : (idx + 1) * dh] += Om
            G[:, idx * dh : (idx + 1) * dh] += -nbr_poses[k] @ T @ Om

    X = rng.standard_normal((n, r, dh))
    f = float(quadratic.cost(qd, jnp.asarray(X)))
    f_dense = oracle.dense_f(oracle.flat(X), Q, G)
    np.testing.assert_allclose(f, f_dense, rtol=1e-12)
    g = np.asarray(quadratic.euc_grad(qd, jnp.asarray(X)))
    g_dense = oracle.unflat(oracle.dense_euc_grad(oracle.flat(X), Q, G), n, d)
    np.testing.assert_allclose(g, g_dense, rtol=1e-11, atol=1e-9)


def test_priors():
    """Prior contributions to Q and G (PoseGraph.cpp:461-469, 565-575)."""
    from dpgo_tpu.types import PRIOR_KAPPA, PRIOR_TAU

    rng = np.random.default_rng(14)
    n, d, r = 4, 3, 5
    dh = d + 1
    meas, _ = oracle.random_measurements(rng, n, d, 0)
    edges = EdgeArrays.from_measurements(meas)
    P = rng.standard_normal((r, dh))

    problem = quadratic.make_local_problem(
        n=n, d=d,
        priv_i=edges.p1, priv_j=edges.p2,
        priv_T=homogeneous(edges.R, edges.t),
        priv_kappa=edges.kappa, priv_tau=edges.tau, priv_weight=edges.weight,
        prior_idx=[0], prior_pose=P[None], prior_mask=[1.0],
        r=r,
    )
    qd = quadratic.build_quadratic_data(problem, jnp.zeros((1, r, dh)), r=r)

    Q = oracle.dense_connection_laplacian(meas, n)
    Om = np.diag([PRIOR_KAPPA] * d + [PRIOR_TAU])
    Q[:dh, :dh] += Om
    G = np.zeros((r, dh * n))
    G[:, :dh] = -P @ Om

    X = rng.standard_normal((n, r, dh))
    np.testing.assert_allclose(
        float(quadratic.cost(qd, jnp.asarray(X))),
        oracle.dense_f(oracle.flat(X), Q, G),
        rtol=1e-12,
    )


def test_rie_hess_is_symmetric():
    """The Riemannian Hessian (with Weingarten correction) must be
    self-adjoint on the tangent space."""
    rng = np.random.default_rng(15)
    n, d, r = 6, 3, 5
    _, qd, _ = _random_problem(rng, n, d, r)
    X = np.asarray(lifted.project_lifted(jnp.asarray(rng.standard_normal((n, r, d + 1)))))
    eg = quadratic.euc_grad(qd, jnp.asarray(X))
    S = quadratic.hess_correction(jnp.asarray(X), eg)
    U = np.asarray(lifted.proj_tangent(jnp.asarray(X), jnp.asarray(rng.standard_normal((n, r, d + 1)))))
    W = np.asarray(lifted.proj_tangent(jnp.asarray(X), jnp.asarray(rng.standard_normal((n, r, d + 1)))))
    HU = quadratic.rie_hess_vec(qd, jnp.asarray(X), S, jnp.asarray(U))
    HW = quadratic.rie_hess_vec(qd, jnp.asarray(X), S, jnp.asarray(W))
    lhs = float(jnp.vdot(jnp.asarray(W), HU))
    rhs = float(jnp.vdot(jnp.asarray(U), HW))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_precond_spd():
    rng = np.random.default_rng(16)
    n, d, r = 6, 3, 5
    _, qd, _ = _random_problem(rng, n, d, r)
    X = np.asarray(lifted.project_lifted(jnp.asarray(rng.standard_normal((n, r, d + 1)))))
    V = np.asarray(lifted.proj_tangent(jnp.asarray(X), jnp.asarray(rng.standard_normal((n, r, d + 1)))))
    PV = quadratic.apply_precond(qd, jnp.asarray(X), jnp.asarray(V))
    assert float(jnp.vdot(jnp.asarray(V), PV)) > 0


def test_band_split_matches_plain():
    """The (experimental) odometry-band split produces identical matvecs."""
    rng = np.random.default_rng(17)
    n, d, r = 12, 3, 5
    meas, _ = oracle.random_measurements(rng, n, d, 4)
    edges = EdgeArrays.from_measurements(meas)
    p_plain = quadratic.from_private_measurements(edges, n=n, d=d, band=False)
    p_band = quadratic.from_private_measurements(edges, n=n, d=d, band=True)
    # cost-model lane selection: at tiny n the full-coverage exception lanes
    # every edge (deleting the gather path entirely); at minimum the
    # odometry chain is banded
    assert p_band.num_band >= n - 1
    assert 1 in p_band.band_offsets
    qd_a = quadratic.build_quadratic_data(p_plain, jnp.zeros((1, r, d + 1)), r=r)
    qd_b = quadratic.build_quadratic_data(p_band, jnp.zeros((1, r, d + 1)), r=r)
    V = rng.standard_normal((n, r, d + 1))
    out_a = np.asarray(quadratic.q_matvec(qd_a, jnp.asarray(V)))
    out_b = np.asarray(quadratic.q_matvec(qd_b, jnp.asarray(V)))
    np.testing.assert_allclose(out_a, out_b, rtol=1e-12, atol=1e-12)


def test_negative_offset_lanes_match_plain():
    """Backward edges (p2 < p1) are never flipped — the lifted translation
    cost is not invariant under edge reversal (ADVICE r2). They instead get
    negative-offset lanes; the lane matvec must match the gather path and the
    dense oracle exactly."""
    rng = np.random.default_rng(18)
    n, d, r = 16, 3, 5
    meas, _ = oracle.random_measurements(rng, n, d, 3)
    # add a backward "lane" of edges at offset -4 plus odd backward edges
    from dpgo_tpu.measurements import RelativeSEMeasurement
    from dpgo_tpu.solvers.averaging import project_to_rotation_group

    def back(i, j):
        R = project_to_rotation_group(rng.standard_normal((d, d)))
        return RelativeSEMeasurement(0, 0, i, j, R, rng.standard_normal(d), 2.0, 1.0)

    meas = meas + [back(i, i - 4) for i in range(4, n)] + [back(9, 2), back(14, 3)]
    edges = EdgeArrays.from_measurements(meas)
    p_plain = quadratic.from_private_measurements(edges, n=n, d=d, band=False)
    p_band = quadratic.plan_bands(
        quadratic.from_private_measurements(edges, n=n, d=d, band=False),
        offsets=(-4, 1),
    )
    assert p_band.num_band == (n - 1) + (n - 4)
    assert -4 in p_band.band_offsets
    qd_a = quadratic.build_quadratic_data(p_plain, jnp.zeros((1, r, d + 1)), r=r)
    qd_b = quadratic.build_quadratic_data(p_band, jnp.zeros((1, r, d + 1)), r=r)
    Qdense = oracle.dense_connection_laplacian(meas, n)
    V = rng.standard_normal((n, r, d + 1))
    out_a = np.asarray(quadratic.q_matvec(qd_a, jnp.asarray(V)))
    out_b = np.asarray(quadratic.q_matvec(qd_b, jnp.asarray(V)))
    out_dense = oracle.unflat(oracle.flat(V) @ Qdense, n, d)
    np.testing.assert_allclose(out_a, out_dense, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(out_b, out_dense, rtol=1e-12, atol=1e-10)


def test_choose_band_offsets_negative_and_eviction():
    """choose_band_offsets admits negative offsets, and forcing the odometry
    offset in evicts the LOWEST-count lane (ADVICE r2 low)."""
    # 60 edges at offset -3, 50 at offset +7, 40 at offset 2, 30 odometry
    i_np = np.concatenate([
        np.arange(60) + 3, np.arange(50), np.arange(40), np.arange(30),
    ])
    j_np = np.concatenate([
        np.arange(60), np.arange(50) + 7, np.arange(40) + 2, np.arange(30) + 1,
    ])
    offs = quadratic.choose_band_offsets(i_np, j_np, n=100, min_count=20)
    assert set(offs) == {-3, 7, 2, 1}
    # with max_lanes=3 and 1 not among the top lanes, the lowest-count
    # non-odometry lane (offset 2, count 40) is evicted — not the top one
    offs3 = quadratic.choose_band_offsets(
        i_np, j_np, n=100, min_count=20, max_lanes=3
    )
    assert set(offs3) == {-3, 7, 1}


def test_residual_form_matches_matvec_form():
    """cost_grad_residual == (cost, euc_grad) up to the documented constant
    objective offset, on a problem with private + shared edges + priors."""
    rng = np.random.default_rng(19)
    n, d, r = 6, 3, 5
    dh = d + 1
    meas, _ = oracle.random_measurements(rng, n, d, 2)
    edges = EdgeArrays.from_measurements(meas)
    from dpgo_tpu.solvers.averaging import project_to_rotation_group

    def rand_T():
        R = project_to_rotation_group(rng.standard_normal((d, d)))
        return homogeneous(R, rng.standard_normal(d))

    Ts = np.stack([rand_T(), rand_T()])
    nbr_poses = rng.standard_normal((2, r, dh))
    P = rng.standard_normal((r, dh))
    problem = quadratic.make_local_problem(
        n=n, d=d,
        priv_i=edges.p1, priv_j=edges.p2,
        priv_T=homogeneous(edges.R, edges.t),
        priv_kappa=edges.kappa, priv_tau=edges.tau, priv_weight=edges.weight,
        shared_idx=[1, 4], shared_T=Ts,
        shared_kappa=[2.0, 3.0], shared_tau=[1.5, 0.5],
        shared_weight=[0.7, 1.0], shared_outgoing=[True, False],
        shared_nbr_slot=[0, 1], shared_mask=[1.0, 1.0],
        prior_idx=[2], prior_pose=P[None], prior_mask=[1.0],
        r=r,
    )
    qd = quadratic.build_quadratic_data(problem, jnp.asarray(nbr_poses), r=r)
    rd = quadratic.build_residual_data(problem, jnp.asarray(nbr_poses))

    X = rng.standard_normal((n, r, dh))
    f_res, g_res = quadratic.cost_grad_residual(rd, jnp.asarray(X))
    g_mv = np.asarray(quadratic.euc_grad(qd, jnp.asarray(X)))
    np.testing.assert_allclose(np.asarray(g_res), g_mv, rtol=1e-11, atol=1e-9)

    # objective matches up to the constant offset: 0.5||nbr||^2_om (outgoing)
    # + 0.5||nbr T||^2_om (incoming) + 0.5||P||^2_om (priors)
    from dpgo_tpu.types import PRIOR_KAPPA, PRIOR_TAU

    om = lambda k, t, w: np.array([w * k] * d + [w * t])
    const = 0.5 * np.sum(om(2.0, 1.5, 0.7)[None, :] * nbr_poses[0] ** 2)
    nbrT = nbr_poses[1] @ np.asarray(Ts[1])
    const += 0.5 * np.sum(om(3.0, 0.5, 1.0)[None, :] * nbrT**2)
    const += 0.5 * np.sum(np.array([PRIOR_KAPPA] * d + [PRIOR_TAU])[None, :] * P**2)
    f_mv = float(quadratic.cost(qd, jnp.asarray(X)))
    np.testing.assert_allclose(float(f_res), f_mv + const, rtol=1e-12)


def test_residual_form_f32_accuracy_near_optimum():
    """Near a minimizer, the f32-cast residual-form gradient is at least as
    accurate as the f32-cast matvec form (both are dominated by the f32
    quantization of the evaluation point itself — measured ratio ~0.77; the
    residual form's decisive role is enabling delta-state evaluation, where
    the point is never materialized in reduced precision)."""
    rng = np.random.default_rng(20)
    n, d, r = 200, 3, 5
    meas, (Rw, tw) = oracle.random_measurements(rng, n, d, 40)
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    qd = quadratic.build_quadratic_data(problem, jnp.zeros((1, r, d + 1)), r=r)
    rd = quadratic.build_residual_data(problem, jnp.zeros((1, r, d + 1)))
    # a genuine near-minimizer: start from the lifted ground truth and run
    # the f64 RTR to a tight tolerance (residuals stay ~ the 0.01 measurement
    # noise while pose entries are O(1) — the cancellation regime)
    from dpgo_tpu.ops import lifted as lifted_ops
    from dpgo_tpu.solvers import rtr as rtr_mod

    Y_lift = np.asarray(lifted_ops.fixed_stiefel_variable(d, r))
    T_true = np.concatenate(
        [np.stack(Rw), np.stack(tw)[:, :, None]], axis=2
    )  # (n, d, dh)
    X0 = np.einsum("rd,nde->nre", Y_lift, T_true)
    X, _ = rtr_mod.rtr_solve(
        qd, jnp.asarray(X0), gradnorm_tol=1e-8, initial_radius=100.0,
        max_iterations=50,
    )
    X = np.asarray(X)
    g64 = np.asarray(quadratic.euc_grad(qd, jnp.asarray(X)))
    hi = jax.lax.Precision.HIGHEST
    _, g32_res = quadratic.cost_grad_residual(
        jax.tree.map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, rd),
        jnp.asarray(X, jnp.float32), precision=hi)
    g32_mv = quadratic.q_matvec(
        jax.tree.map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, qd),
        jnp.asarray(X, jnp.float32), precision=hi)
    err_res = np.linalg.norm(np.asarray(g32_res, np.float64) - g64)
    err_mv = np.linalg.norm(np.asarray(g32_mv, np.float64) - g64)
    assert err_res <= 1.2 * err_mv, (err_res, err_mv)
    # absolute accuracy is at the quantization level, far below the gradient
    # scale of this problem
    assert err_res < 1e-4


def test_choose_band_offsets_cost_model():
    """Lane selection is cost-model driven (round 4): a lane pays a dense
    einsum over EVERY row per matvec, so partial-coverage offsets qualify
    only at count >= rows/3; a full-coverage offset set within the lane
    budget is kept wholesale (it deletes the gather/scatter machinery)."""
    n = 9000
    # odometry chain + a 300-edge loop-closure offset (3.3% coverage) + a
    # 4000-edge offset (44% coverage) + 17 scattered stray offsets (so the
    # full-coverage exception cannot fire): only the big one joins odometry
    i1 = np.arange(n - 1)
    i2 = np.arange(300) + 77
    i3 = np.arange(4000) + 11
    i4 = np.arange(17) * 3 + 1000  # 17 edges at 17 distinct offsets
    i_np = np.concatenate([i1, i2, i3, i4])
    j_np = np.concatenate(
        [i1 + 1, i2 - 77, i3 + 11, i4 + 200 + np.arange(17)]
    )
    offs = quadratic.choose_band_offsets(i_np, j_np, n=n)
    assert set(offs) == {1, 11}, offs
    # the same counts against a 10x-stacked SPMD row count drop the 4000-
    # edge lane too (4000 < 10*n/3): pooled counts must beat POOLED rows
    offs_stacked = quadratic.choose_band_offsets(i_np, j_np, n=n, rows=10 * n)
    assert set(offs_stacked) == {1}, offs_stacked
    # full coverage within the budget -> keep every offset, however small
    # (here: odometry + one 40-edge offset and nothing else)
    i_fc = np.concatenate([i1, np.arange(40)])
    j_fc = np.concatenate([i1 + 1, np.arange(40) + 500])
    offs_fc = quadratic.choose_band_offsets(i_fc, j_fc, n=n)
    assert set(offs_fc) == {1, 500}, offs_fc


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("d", [2, 3])
def test_q_matvec_scatter_path_matches_dense_at_scale(d, dtype):
    """The gather/scatter path of q_matvec at >= 4096 off-lane edges (the
    shapes where a custom segment-sum kernel once replaced the scatter)
    against the dense oracle, in f64 and f32."""
    rng = np.random.default_rng(20 + d)
    n, r = 1024, d + 2
    meas, _ = oracle.random_measurements(rng, n, d, extra_lc=4400)
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d,
                                                  dtype=dtype)
    qd = quadratic.build_quadratic_data(
        problem, jnp.zeros((1, r, d + 1), dtype), r=r
    )
    assert qd.off_E.shape[0] >= 4096
    Qdense = oracle.dense_connection_laplacian(meas, n)
    V = rng.standard_normal((n, r, d + 1))
    out = np.asarray(quadratic.q_matvec(qd, jnp.asarray(V, dtype)),
                     np.float64)
    assert out.dtype == np.float64 and out.shape == V.shape
    out_dense = oracle.unflat(oracle.flat(V) @ Qdense, n, d)
    scale = np.abs(out_dense).max()
    # f32: inputs rounded to 2^-24 and ~deg-term sums per row
    atol = 1e-10 * scale if dtype == jnp.float64 else 2e-5 * scale
    np.testing.assert_allclose(out, out_dense, rtol=0, atol=atol)
