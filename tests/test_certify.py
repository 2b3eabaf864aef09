"""Global-optimality certificate + Riemannian staircase (solvers/certify.py).

The reference never evaluates the dual certificate its papers are named for
(it stops on gradient norm, PGOAgent.cpp:846-878); these tests pin down the
implementation: matrix-free S = Q - LambdaHat, Lanczos lambda_min
against a dense oracle, certification of converged solves, and the staircase
escape from a deliberately suboptimal critical point.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu import quadratic
from dpgo_tpu.io.g2o import read_g2o_file
from dpgo_tpu.measurements import EdgeArrays
from dpgo_tpu.ops import lifted
from dpgo_tpu.solvers import certify
from dpgo_tpu.solvers import rtr as rtr_mod
from dpgo_tpu.solvers.pgo import chordal_initialization


def _setup(path, r):
    meas, n = read_g2o_file(path)
    d = meas[0].d
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    # precond='auto' (the production centralized config): the certificate's
    # preconditioned eigen-refinement inherits the solver's factor — the
    # exact banded factor reaches residual ~1e-6 on sphere2500 where
    # block-Jacobi crawls.
    qd = quadratic.build_quadratic_data(
        problem, jnp.zeros((1, r, d + 1)), r=r, precond="auto"
    )
    T = chordal_initialization(meas)
    Y = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = jnp.asarray(np.einsum("rd,nde->nre", Y, T))
    return meas, n, d, qd, X0


def _dense_S(qd, X, n, dh):
    """Dense certificate matrix via the matrix-free action on basis vectors
    (independent oracle for the eigen-solver)."""
    Lam = certify.kkt_multipliers(qd, X)
    m = n * dh
    cols = []
    for e in range(m):
        v = jnp.zeros((m,), X.dtype).at[e].set(1.0).reshape(n, 1, dh)
        cols.append(
            np.asarray(certify.certificate_matvec(qd, Lam, v)).reshape(m)
        )
    return np.stack(cols, axis=0)


def test_lambda_min_matches_dense_oracle():
    """Deflated Lanczos vs dense eigh on tinyGrid3D: the point estimate is
    an upper bound and the rigorous bound a lower bound on lambda_min(S)
    ANYWHERE; at a tightly-solved critical point both pinch the dense value
    (the deflated subspace split becomes exact there)."""
    _meas, n, d, qd, X0 = _setup("/root/reference/data/tinyGrid3D.g2o", 5)
    dh = d + 1
    # sandwich property at a non-critical point
    S0 = _dense_S(qd, X0, n, dh)
    np.testing.assert_allclose(S0, S0.T, atol=1e-9)  # symmetric
    lam0 = np.linalg.eigvalsh(S0)[0]
    r0 = certify.min_eig_certificate(qd, X0, k=n * dh)
    assert r0.lambda_min_lower <= lam0 + 1e-8
    assert r0.lambda_min >= lam0 - 1e-8

    # exactness at a critical point
    X, stats = rtr_mod.rtr_solve(
        qd, X0, gradnorm_tol=1e-10, initial_radius=100.0,
        max_iterations=100, max_inner=200,
    )
    S = _dense_S(qd, X, n, dh)
    lam_dense = np.linalg.eigvalsh(0.5 * (S + S.T))[0]
    res = certify.min_eig_certificate(qd, X, k=n * dh)
    assert res.eig_residual < 1e-6
    np.testing.assert_allclose(res.lambda_min, lam_dense, atol=1e-6)
    assert res.lambda_min_lower <= lam_dense + 1e-12
    assert res.lambda_min_lower > lam_dense - 1e-6


def test_certified_at_global_optimum():
    """After a tight RTR solve at r=5, the certificate passes on smallGrid3D
    (lambda_min >= -eta; the translation-gauge null vector keeps it <= 0)."""
    _meas, n, d, qd, X0 = _setup("/root/reference/data/smallGrid3D.g2o", 5)
    X, stats = rtr_mod.rtr_solve(
        qd, X0, gradnorm_tol=1e-8, initial_radius=100.0,
        max_iterations=100, max_inner=200,
    )
    assert float(stats.gnorm_opt) < 1e-8
    res = certify.min_eig_certificate(qd, X, k=64, eta=1e-6)
    assert res.stationarity < 1e-7
    assert res.certified, res
    # true lambda_min(S) is 0 (S annihilates rowspace(X) + gauge); the
    # deflated complement has a genuine spectral gap (~2.0 on this graph)
    assert abs(res.lambda_min) < 1e-6
    assert res.lambda_min_lower > -1e-6


def _conflicted_ring(n=12, lc_angle=np.pi):
    """SE(2) ring whose loop closure contradicts the odometry by lc_angle —
    at lc_angle = pi the r = d problem has a genuine suboptimal critical
    point reachable from the odometry init (the classic two-basin PGO
    instance; measured: cost 27.34 vs the certified optimum 21.96)."""
    from dpgo_tpu.measurements import RelativeSEMeasurement

    theta = 2 * np.pi / n

    def rot(a):
        return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])

    meas = []
    for i in range(n - 1):
        meas.append(RelativeSEMeasurement(
            r1=0, p1=i, r2=0, p2=i + 1, R=rot(theta), t=np.array([1.0, 0.0]),
            kappa=10.0, tau=10.0,
        ))
    meas.append(RelativeSEMeasurement(
        r1=0, p1=n - 1, r2=0, p2=0, R=rot(lc_angle), t=np.array([1.0, 0.0]),
        kappa=10.0, tau=10.0,
    ))
    return meas, n


def test_staircase_escapes_suboptimal_critical_point():
    """From an odometry init on the conflicted ring, the r = d solve lands
    on a critical point the certificate REJECTS (lambda_min < 0); the
    staircase escapes along the negative eigenvector and certifies at a
    higher rank with a strictly lower cost."""
    from dpgo_tpu.solvers.pgo import odometry_initialization

    meas, n = _conflicted_ring(12, np.pi)
    T0 = odometry_initialization(meas[:-1])  # chain only, no loop closure
    res = certify.solve_pgo_staircase(
        meas, r0=2, r_max=8, gradnorm_tol=1e-9, eta=1e-6, T0=np.asarray(T0),
    )
    hist = res.history
    assert not hist[0]["certified"] and hist[0]["lambda_min"] < -1e-2, hist[0]
    assert res.certified
    assert res.r > 2
    assert res.cost < hist[0]["cost"] - 1.0
    # The reference's scheme (fixed rank lift, terminate on gradnorm, no
    # certificate) is FOOLED on this instance: an independent r=5 solve from
    # chordal init first-order-converges at the lifted saddle (cost 27.34).
    # The certificate rejects that point; the staircase's certified cost is
    # strictly lower — the capability the reference's papers name but its
    # code never checks.
    _m, _n, d, qd5, X0 = _setup_from(meas, 5)
    X5, st5 = rtr_mod.rtr_solve(
        qd5, X0, gradnorm_tol=1e-9, initial_radius=100.0,
        max_iterations=100, max_inner=200,
    )
    c5 = 2 * float(quadratic.cost(qd5, X5))
    if float(st5.gnorm_opt) < 1e-8 and c5 > res.cost + 1e-6:
        cert5 = certify.min_eig_certificate(qd5, X5, k=48)
        assert not cert5.certified and cert5.lambda_min < -1e-3
    assert res.cost <= c5 + 1e-6


def _setup_from(meas, r):
    n = max(max(m.p1, m.p2) for m in meas) + 1
    d = meas[0].d
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    qd = quadratic.build_quadratic_data(
        problem, jnp.zeros((1, r, d + 1)), r=r
    )
    T = chordal_initialization(meas)
    Y = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = jnp.asarray(np.einsum("rd,nde->nre", Y, T))
    return meas, n, d, qd, X0


@pytest.mark.slow
def test_certify_sphere2500_global_optimum():
    """sphere2500's converged solve is certified GLOBALLY optimal by the
    dual certificate — an independent proof of the 1687.0058 anchor the
    parity suite asserts against published SE-Sync values (and a capability
    the reference does not have)."""
    _meas, n, d, qd, X0 = _setup("/root/reference/data/sphere2500.g2o", 5)
    X, stats = rtr_mod.rtr_solve(
        qd, X0, gradnorm_tol=1e-6, initial_radius=100.0,
        max_iterations=200, max_inner=500,
    )
    if float(stats.gnorm_opt) >= 1e-6:  # polish from the near-solution
        X, stats = rtr_mod.rtr_solve(
            qd, X, gradnorm_tol=1e-6, initial_radius=1.0,
            max_iterations=200, max_inner=500,
        )
    assert float(stats.gnorm_opt) < 1e-6, float(stats.gnorm_opt)
    np.testing.assert_allclose(
        2 * float(quadratic.cost(qd, X)), 1687.00581, rtol=1e-6
    )
    res = certify.min_eig_certificate(qd, X, k=64, eta=1e-5)
    assert res.stationarity < 1e-4
    assert res.certified, res


def test_certify_distributed_solution():
    """The realistic end-to-end pipeline: distributed SPMD RBCD to its
    tolerance, assemble the global trajectory, (cheap) centralized polish to
    a critical point, certify global optimality — the offline verification
    role the certificate plays in SE-Sync, applied to the distributed
    solver's output."""
    from dpgo_tpu.parallel import spmd

    meas, n = read_g2o_file("/root/reference/data/smallGrid3D.g2o")
    r, N = 5, 4
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=N, r=r)
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state = spmd.initial_state(problem, X0, ranges)
    cfg = spmd.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                          rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(N)))
    run = spmd.make_run_fn(problem, cfg, mesh=None)
    state, metrics, rounds = run(state, 400, 5e-2)
    assert float(metrics.gradnorm) < 0.1
    Xg = spmd.assemble_global(state, ranges, n)

    # distributed iterate is eta-far from critical: the certificate bound
    # honestly reflects that through the coupling term
    loose = certify.certify_solution(meas, Xg, eta=1e-6, refine_iters=0)
    assert not loose.certified
    assert loose.stationarity < 0.1

    # cheap centralized polish to a critical point, then certify
    _m, _n, d, qd, _X0 = _setup("/root/reference/data/smallGrid3D.g2o", r)
    Xp, stats = rtr_mod.rtr_solve(
        qd, jnp.asarray(Xg), gradnorm_tol=1e-9, initial_radius=1.0,
        max_iterations=50, max_inner=200,
    )
    assert float(stats.gnorm_opt) < 1e-9
    res = certify.certify_solution(meas, np.asarray(Xp), eta=1e-6)
    assert res.certified, res
    # and the polished cost matches the distributed one to its tolerance
    c_dist = float(quadratic.cost(qd, jnp.asarray(Xg)))
    c_pol = float(quadratic.cost(qd, Xp))
    assert c_pol <= c_dist + 1e-12
    np.testing.assert_allclose(c_dist, c_pol, rtol=1e-3)


@pytest.mark.slow
def test_certify_city10000_global_optimum():
    """city10000 (SE(2), 10,000 poses): the centralized solve is certified
    globally optimal — the optimum (638.6246) that the distributed bench's
    'within 0.6%' claim is measured against is now a proven global optimum,
    not just a converged value."""
    _meas, n, d, qd, X0 = _setup("/root/reference/data/city10000.g2o", 3)
    X, stats = rtr_mod.rtr_solve(
        qd, X0, gradnorm_tol=1e-6, initial_radius=100.0,
        max_iterations=300, max_inner=500,
    )
    assert float(stats.gnorm_opt) < 1e-6, float(stats.gnorm_opt)
    np.testing.assert_allclose(2 * float(stats.f_opt), 638.6246, rtol=1e-5)
    res = certify.min_eig_certificate(qd, X, k=64, eta=1e-5)
    assert res.certified, res
    assert res.lambda_min_lower > -1e-8
