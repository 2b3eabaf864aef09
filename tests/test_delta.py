"""Anchored delta-state engine tests (parallel/delta.py): the certified
f32-only accuracy path for the 100k scale target."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpgo_tpu import quadratic
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel import delta as delta_mod
from dpgo_tpu.parallel import spmd
from dpgo_tpu.parallel.simulation import build_central_evaluation
from dpgo_tpu.solvers.pgo import chordal_initialization


def test_delta_polar_matches_exact_polar():
    """delta_polar(Y_ref, M_ref, W) + Y_ref == polar(Y_ref + W), computed to
    ~f32 eps of the SMALL quantities even though it never forms the identity
    or an O(1) intermediate."""
    rng = np.random.default_rng(50)
    r, d = 5, 3
    for _ in range(20):
        # anchor: near-orthonormal with a genuine defect (as after f32
        # rounding of a host re-anchor)
        Y0, _ = np.linalg.qr(rng.standard_normal((r, d)))
        Y_ref = (Y0 + 1e-4 * rng.standard_normal((r, d))).astype(np.float32)
        M_ref = (Y_ref.astype(np.float64).T @ Y_ref.astype(np.float64)
                 - np.eye(d)).astype(np.float32)
        W = (1e-3 * rng.standard_normal((r, d))).astype(np.float32)

        out = delta_mod.delta_polar(
            jnp.asarray(Y_ref), jnp.asarray(M_ref), jnp.asarray(W)
        )
        Y_new = Y_ref.astype(np.float64) + np.asarray(out, np.float64)
        # exact polar in f64
        A = Y_ref.astype(np.float64) + W.astype(np.float64)
        U, _, Vt = np.linalg.svd(A, full_matrices=False)
        P = U @ Vt
        np.testing.assert_allclose(Y_new, P, atol=5e-7)
        # the result is orthonormal far beyond what an O(1)-forming f32
        # computation could guarantee relative to the inputs
        assert np.abs(Y_new.T @ Y_new - np.eye(d)).max() < 5e-7

        # LARGE W (Nesterov extrapolation regime): the pre-scaled delta-NS
        # stays globally convergent — the result is the correct polar factor
        W_big = rng.standard_normal((r, d)).astype(np.float32)
        out_b = delta_mod.delta_polar(
            jnp.asarray(Y_ref), jnp.asarray(M_ref), jnp.asarray(W_big)
        )
        Yb = Y_ref.astype(np.float64) + np.asarray(out_b, np.float64)
        Ab = Y_ref.astype(np.float64) + W_big.astype(np.float64)
        Ub, _, Vtb = np.linalg.svd(Ab, full_matrices=False)
        np.testing.assert_allclose(Yb, Ub @ Vtb, atol=2e-5)


def test_delta_engine_matches_f64_optimum(tiny_grid):
    """The delta engine (f32 problem, f32 deltas, host f64 anchor) reaches
    the f64 engine's optimum on the 9-pose grid world, certified by a host-side f64
    gradient evaluation."""
    meas, n = tiny_grid
    r = 5
    N = 4
    problem64, ranges = spmd.build_spmd_problem(meas, n, num_agents=N, r=r)
    problem32, _ = spmd.build_spmd_problem(
        meas, n, num_agents=N, r=r, dtype=jnp.float32
    )
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)

    # f64 reference run
    state64 = spmd.initial_state(problem64, X0, ranges)
    cfg64 = spmd.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                            rtr_gradnorm_tol=1e-3 / (2 * np.sqrt(N)))
    run64 = spmd.make_run_fn(problem64, cfg64, mesh=None)
    s64, m64, _ = run64(state64, 400, 1e-3)
    assert float(m64.gradnorm) < 1e-3

    # delta engine from the same init
    X0_stack = np.zeros((N, problem32.n_max, r, 4))
    for a, (s, e) in enumerate(ranges):
        X0_stack[a, : e - s] = X0[s:e]
        # padded rows: identity-lifted (same convention as initial_state)
        X0_stack[a, e - s:] = np.asarray(
            lifted.identity_lifted(problem32.n_max - (e - s), r, 3)
        )
    cfg32 = spmd.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                            rtr_gradnorm_tol=1e-3 / (2 * np.sqrt(N)))
    X_final, info = delta_mod.run_delta_certified(
        problem32, X0_stack, cfg32, tol=1e-3, chunk=20, max_rounds=600,
    )
    assert info["device_gradnorm"] < 1e-3

    # honest certification: f64 host evaluation of the global gradnorm
    qd_central = build_central_evaluation(meas, n, r)
    Xg = np.zeros((n, r, 4))
    for a, (s, e) in enumerate(ranges):
        Xg[s:e] = X_final[a, : e - s]
    g64 = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(Xg)))
    assert g64 < 2e-3
    # same optimum as the f64 engine
    c64 = float(quadratic.cost(qd_central, jnp.asarray(Xg)))
    c_ref = float(quadratic.cost(
        qd_central, jnp.asarray(spmd.assemble_global(s64, ranges, n))
    ))
    np.testing.assert_allclose(c64, c_ref, rtol=1e-5)


def test_delta_engine_beats_f32_floor():
    """The whole point: on a world whose coordinates sit FAR from the origin
    (a global translation — a gauge transformation, so edges, optimum
    structure, and conditioning are all unchanged; think UTM coordinates in
    real SLAM), the plain f32 engine's iterate must store huge pose values
    and its reachable gradient norm is floored by eps_f32·|coordinate|,
    while the delta engine (host-f64 anchor, f32 deltas) certifies below
    the tolerance."""
    from dpgo_tpu.datasets import synthesize_grid3d

    offset = 30000.0
    edges, n, T_true = synthesize_grid3d(216, seed=3)
    meas = edges.to_measurements()
    r = 5
    N = 4
    problem32, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=N, r=r, dtype=jnp.float32
    )
    T = np.asarray(T_true).copy()
    T[:, :, 3] += offset  # global translation: pure gauge
    # start near the (noisy-world) optimum: lifted ground truth
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)

    qd_central = build_central_evaluation(meas, n, r)
    tol = 1e-2

    # plain f32 engine: floored above tol (host f64 evaluation)
    state32 = spmd.initial_state(problem32, X0.astype(np.float32), ranges)
    cfg = spmd.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                          rtr_gradnorm_tol=tol / (2 * np.sqrt(N)))
    run32 = spmd.make_run_fn(problem32, cfg, mesh=None)
    s32, m32, _ = run32(state32, 150, 0.0)
    X32 = spmd.assemble_global(s32, ranges, n)
    g32 = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(X32)))

    # delta engine: certifies below tol from the same start
    X0_stack = np.zeros((N, problem32.n_max, r, 4))
    for a, (s, e) in enumerate(ranges):
        X0_stack[a, : e - s] = X0[s:e]
        X0_stack[a, e - s:] = np.asarray(
            lifted.identity_lifted(problem32.n_max - (e - s), r, 3)
        )
    X_final, info = delta_mod.run_delta_certified(
        problem32, X0_stack, cfg, tol=tol / 2, chunk=25, max_rounds=400,
    )
    Xg = np.zeros((n, r, 4))
    for a, (s, e) in enumerate(ranges):
        Xg[s:e] = X_final[a, : e - s]
    gd = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(Xg)))

    assert g32 > tol, f"f32 floor unexpectedly below tol: {g32}"
    assert gd < tol, f"delta engine failed to certify: {gd}"


def test_host_certify_matches_central_evaluation(small_grid):
    """host_certify (pure numpy f64) equals the central-evaluation
    cost/gradnorm (on the 125-pose grid world incl. backward + shared
    edges)."""
    meas, n = small_grid
    r, N = 5, 4
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=N, r=r)
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    X_stack = np.zeros((N, problem.n_max, r, 4))
    for a, (s, e) in enumerate(ranges):
        X_stack[a, : e - s] = X0[s:e]
        X_stack[a, e - s:] = np.asarray(
            lifted.identity_lifted(problem.n_max - (e - s), r, 3)
        )
    cost, gnorm = delta_mod.host_certify(problem, X_stack)
    qd_central = build_central_evaluation(meas, n, r)
    cost_c = float(quadratic.cost(qd_central, jnp.asarray(X0)))
    gnorm_c = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(X0)))
    np.testing.assert_allclose(cost, 2 * cost_c, rtol=1e-10)
    np.testing.assert_allclose(gnorm, gnorm_c, rtol=1e-9)


def test_delta_sharded_matches_single_device(tiny_grid):
    """The fused delta driver on a 4-device mesh (shard_map + all_gather of
    public deltas, psum'd metrics) matches the single-device batched path —
    the mesh analog of test_spmd.py::test_sharded_matches_single_device for
    the certification engine (the 100k flagship path)."""
    from jax.sharding import Mesh

    meas, n = tiny_grid
    r, N = 5, 4
    problem, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=N, r=r, dtype=jnp.float32
    )
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    X0_stack = np.zeros((N, problem.n_max, r, 4))
    for a, (s, e) in enumerate(ranges):
        X0_stack[a, : e - s] = X0[s:e]
        X0_stack[a, e - s:] = np.asarray(
            lifted.identity_lifted(problem.n_max - (e - s), r, 3)
        )
    cfg = spmd.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                          rtr_gradnorm_tol=1e-3 / (2 * np.sqrt(N)),
                          rtr_residual_control=True)

    run_local = delta_mod.make_delta_run_fn(problem, cfg, mesh=None,
                                            reanchor_every=5)
    mesh = Mesh(np.array(jax.devices()[:4]), ("agents",))
    run_shard = delta_mod.make_delta_run_fn(problem, cfg, mesh=mesh,
                                            reanchor_every=5)

    ref_l = delta_mod.build_delta_ref(problem, X0_stack)
    st_l = delta_mod.initial_delta_state(ref_l)
    ref_s = delta_mod.build_delta_ref(problem, X0_stack)
    st_s = delta_mod.initial_delta_state(ref_s)

    # two chunks: exercises the carry-ref round trip and two anchor folds,
    # while the gradnorm (~1e-2) is still far above the f32 rounding floor
    for _ in range(2):
        st_l, ref_l, m_l, r_l = run_local(ref_l, st_l, 6, 1e-12)
        st_s, ref_s, m_s, r_s = run_shard(ref_s, st_s, 6, 1e-12)
        assert int(r_l) == int(r_s)

    # same iterate to f32 roundoff of the SMALL delta quantities
    pt_l = np.asarray(st_l.ACC, np.float64) + np.asarray(st_l.D, np.float64)
    pt_s = np.asarray(st_s.ACC, np.float64) + np.asarray(st_s.D, np.float64)
    np.testing.assert_allclose(pt_l, pt_s, atol=5e-6)
    np.testing.assert_allclose(float(m_l.cost), float(m_s.cost), rtol=2e-5)
    np.testing.assert_allclose(
        float(m_l.gradnorm), float(m_s.gradnorm), rtol=2e-4
    )

    # and the certified host driver runs end-to-end on the mesh
    X_final, info = delta_mod.run_delta_certified(
        problem, X0_stack, cfg, tol=1e-3, mesh=mesh, chunk=20, max_rounds=400,
    )
    cost_h, gnorm_h = delta_mod.host_certify(problem, X_final)
    assert gnorm_h < 2e-3


def _stack_init(problem, ranges, X0, r=5, d=3):
    X0_stack = np.zeros((len(ranges), problem.n_max, r, d + 1))
    for a, (s, e) in enumerate(ranges):
        X0_stack[a, : e - s] = X0[s:e]
        X0_stack[a, e - s:] = np.asarray(
            lifted.identity_lifted(problem.n_max - (e - s), r, d)
        )
    return X0_stack


def test_delta_gnc_rejects_outlier():
    """GNC-TLS on the delta engine (VERDICT r3 #5): the residual-form
    reweighting drives the planted outlier shared edge's weight to ~0 on
    both agents' copies while keeping the clean loop closures — robust
    outlier rejection now works on the certified-accuracy path, not just
    the plain f32 engine (reference: PGOAgent.cpp:997-1142)."""
    from tests.test_distributed_robust import _two_robot_world

    rng = np.random.default_rng(90)
    meas, n, _ = _two_robot_world(rng, n=8, outlier=True)
    problem, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=2, r=5, dtype=jnp.float32
    )
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, 5))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    X0_stack = _stack_init(problem, ranges, X0)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    problem_out, state, ref, X64, hist = delta_mod.run_delta_gnc(
        problem, X0_stack, cfg,
        barc=5.0, init_mu=None, mu_step=1.4,
        num_weight_updates=16, inner_rounds=15,
    )
    w = np.asarray(problem_out.shared_weight)
    fx = np.asarray(problem_out.shared_fixed_weight)
    real = ~fx & (np.asarray(problem_out.shared_kappa) > 0)
    weights = np.sort(w[real])
    assert weights[0] < 1e-3  # both copies of the outlier edge
    assert weights[-1] > 0.9
    per_agent = [np.sort(w[a][real[a]]) for a in range(2)]
    for pa in per_agent:
        assert pa[0] < 1e-3 and pa[-1] > 0.9
    # the reweighted problem then certifies at delta quality: a final
    # accelerated certified run from the GNC iterate reaches the tolerance
    # with the outlier ignored (the GNC phases themselves run unaccelerated,
    # as the reference forbids acceleration under robust costs —
    # PGOAgent.cpp:477)
    cfg_cert = spmd.SPMDConfig(
        mode="all", acceleration=True, adaptive_restart=True,
        rtr_iterations=1, rtr_gradnorm_tol=1e-3 / (2 * np.sqrt(2)),
    )
    X_final, info = delta_mod.run_delta_certified(
        problem_out, X64, cfg_cert, tol=1e-3, chunk=25, max_rounds=800,
    )
    cost_h, gnorm_h = delta_mod.host_certify(problem_out, X_final)
    assert gnorm_h < 2e-3


def test_delta_gnc_sharded_matches_single_device():
    """The delta-GNC flow on a 2-device mesh produces the same weight
    decisions as the single-device run (the mesh test of VERDICT r3 #5)."""
    from jax.sharding import Mesh

    from tests.test_distributed_robust import _two_robot_world

    rng = np.random.default_rng(91)
    meas, n, _ = _two_robot_world(rng, n=8, outlier=True)
    problem, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=2, r=5, dtype=jnp.float32
    )
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, 5))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    X0_stack = _stack_init(problem, ranges, X0)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    mesh = Mesh(np.array(jax.devices()[:2]), ("agents",))
    pr_mesh, *_rest = delta_mod.run_delta_gnc(
        problem, X0_stack, cfg, barc=5.0, init_mu=None,
        num_weight_updates=16, inner_rounds=15, mesh=mesh,
    )
    pr_local, *_rest = delta_mod.run_delta_gnc(
        problem, X0_stack, cfg, barc=5.0, init_mu=None,
        num_weight_updates=16, inner_rounds=15,
    )
    w_m = np.asarray(pr_mesh.shared_weight)
    w_l = np.asarray(pr_local.shared_weight)
    real = (~np.asarray(problem.shared_fixed_weight)
            & (np.asarray(problem.shared_kappa) > 0))
    # same accept/reject decisions on every real shared edge
    np.testing.assert_array_equal(w_m[real] < 1e-3, w_l[real] < 1e-3)
    assert np.sort(w_m[real])[0] < 1e-3


def test_delta_elastic_membership(small_grid):
    """Elastic membership on the delta engine: a robot deactivates mid-run —
    its block (anchor + delta) freezes exactly, its shared edges drop from
    the team metrics, GNC leaves its edges' weights untouched — then
    reactivates and the full team converges (reference:
    PGOAgent.cpp:1173-1184)."""
    meas, n = small_grid
    r, N = 5, 4
    problem, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=N, r=r, dtype=jnp.float32
    )
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    X0_stack = _stack_init(problem, ranges, X0)
    # accelerated, the engine's production mode: Jacobi-parallel RBCD
    # without momentum crawls below gradnorm ~3e-2 on this world
    cfg = spmd.SPMDConfig(mode="all", acceleration=True, rtr_iterations=1,
                          rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(N)))
    run = delta_mod.make_delta_run_fn(problem, cfg, mesh=None,
                                      reanchor_every=5)
    ref = delta_mod.build_delta_ref(problem, X0_stack)
    state = delta_mod.initial_delta_state(ref)

    # phase 1: full team
    state, ref, m1, _ = run(ref, state, 10, 0.0)
    assert np.isfinite(float(m1.cost))

    # phase 2: robot 2 drops out (runtime array change — no recompile)
    active = np.ones(N, bool)
    active[2] = False
    pr_drop = problem.with_robot_active(active)
    pt_before = (np.asarray(state.ACC, np.float64)
                 + np.asarray(state.D, np.float64))[2]
    state, ref, m2, _ = run(ref, state, 30, 0.0, problem=pr_drop)
    pt_after = (np.asarray(state.ACC, np.float64)
                + np.asarray(state.D, np.float64))[2]
    np.testing.assert_array_equal(pt_after, pt_before)
    assert np.isfinite(float(m2.cost))
    assert float(m2.gradnorm) < float(m1.gradnorm)

    # GNC reweighting leaves edges to the inactive neighbor untouched
    pr_w = delta_mod.delta_gnc_reweight(pr_drop, ref, state.D,
                                        barc_sq=25.0, mu=1e-4)
    to_inactive = np.asarray(pr_drop.shared_nbr_robot) == 2
    np.testing.assert_array_equal(
        np.asarray(pr_w.shared_weight)[to_inactive],
        np.asarray(pr_drop.shared_weight)[to_inactive],
    )

    # phase 3: reactivation — the full team converges
    state, ref, m3, _ = run(ref, state, 400, 1e-2, problem=problem)
    assert float(m3.gradnorm) < 1e-2


@pytest.mark.parametrize("scheme", ["exact", "gradient"])
def test_delta_restart_schemes_certify(scheme, tiny_grid):
    """The cancellation-free adaptive-restart signals ('exact': the
    O'Donoghue-Candes function comparison reproduced exactly in delta space
    via f(x')-f(x) = <2 eg(Y) + Q W, x'-x>; 'gradient': <grad f(Y), x'-x>)
    drive the engine to the same certified optimum as the default 'cost'
    comparison. The schemes exist because the accumulated-f32 cost
    comparison fires on rounding noise once true per-round decreases drop
    below eps*|f| (the city2d-100k tail)."""
    meas, n = tiny_grid
    r, N = 5, 4
    problem32, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=N, r=r, dtype=jnp.float32
    )
    T = chordal_initialization(meas)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(3, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    X0_stack = np.zeros((N, problem32.n_max, r, 4))
    for a, (s, e) in enumerate(ranges):
        X0_stack[a, : e - s] = X0[s:e]
        X0_stack[a, e - s:] = np.asarray(
            lifted.identity_lifted(problem32.n_max - (e - s), r, 3)
        )
    cfg = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=1e-3 / (2 * np.sqrt(N)),
        restart_scheme=scheme,
    )
    X_final, info = delta_mod.run_delta_certified(
        problem32, X0_stack, cfg, tol=1e-3, chunk=20, max_rounds=600,
    )
    assert info["device_gradnorm"] < 1e-3
    # honest f64 certification at the assembled iterate
    qd_central = build_central_evaluation(meas, n, r)
    Xg = np.zeros((n, r, 4))
    for a, (s, e) in enumerate(ranges):
        Xg[s:e] = X_final[a, : e - s]
    g64 = float(quadratic.rie_grad_norm(qd_central, jnp.asarray(Xg)))
    assert g64 < 2e-3
