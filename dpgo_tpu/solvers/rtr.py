"""Jit-compiled Riemannian trust-region solver with preconditioned truncated CG.

Replaces ROPTLIB::RTRNewton as driven by the reference's QuadraticOptimizer
(reference: src/QuadraticOptimizer.cpp:50-108):
  * stop on absolute Riemannian gradient norm (GRAD_F criterion),
  * outer-iteration cap (RTR_iterations, default 3),
  * inner tCG cap (RTR_tCG_iterations, default 50),
  * initial radius RTR_initial_radius (default 100), max radius 5x initial,
  * the Max_Iteration==1 "shrink trust region until a step is accepted" mode
    used for every RBCD step (QuadraticOptimizer.cpp:80-98): at most 10
    shrinks by 1/4, else return the initial iterate.

The truncated CG follows the Steihaug-Toint scheme of Absil-Baker-Gallivan
(the algorithm ROPTLIB implements), with the trust region measured in the
preconditioner norm via the standard e_Pe/e_Pd/d_Pd recurrences and the
theta/kappa residual stopping rule (theta=1, kappa=0.1 — ROPTLIB defaults).

Everything runs inside lax.while_loop with static shapes: one compilation per
problem shape, zero host round-trips per solve.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from dpgo_tpu import quadratic
from dpgo_tpu.ops import lifted
from dpgo_tpu.quadratic import QuadraticData
from dpgo_tpu.types import ROptParameters


_THETA = 1.0
_KAPPA = 0.1
_RHO_PRIME = 0.1
_MAX_SHRINKS = 10  # QuadraticOptimizer.cpp:90 ("total_steps > 10")
# tCG caps at or below this STATIC bound run fully unrolled (masked steps
# instead of lax.while_loop): a while_loop body is a fusion barrier — XLA
# materializes the ~5-array (eta, Heta, r, z, delta) carry in device memory
# at every iteration boundary and cannot fuse the preconditioner apply into
# the next Hessian matvec, which matters for the gather-bound tiny-block
# rounds (city2d tcg cap 3). Masked
# unrolling runs all `max_inner` iterations (early-exit work is discarded by
# the same `done` predicate the loop would have tested), so it only pays off
# for small caps where tail rounds hit the cap anyway; larger caps (grid
# tcg=20, centralized 50+) keep the while_loop and its early exit.
_TCG_UNROLL = int(os.environ.get("DPGO_TCG_UNROLL", "4"))


class TCGResult(NamedTuple):
    eta: jax.Array
    Heta: jax.Array
    hit_boundary: jax.Array  # bool: negative curvature or radius exceeded
    num_iters: jax.Array


class RTRState(NamedTuple):
    X: jax.Array
    fx: jax.Array
    grad: jax.Array  # Riemannian gradient
    gnorm: jax.Array
    S: jax.Array  # Weingarten correction sym(Y^T g_euc)
    eg: jax.Array  # Euclidean gradient at X (feeds the residual-mode
    #              cancellation-free decrease identity 0.5<step, eg+eg'>)
    radius: jax.Array
    it: jax.Array
    accepted: jax.Array  # whether the latest step was accepted
    tcg_iters: jax.Array


class RTRStats(NamedTuple):
    f_init: jax.Array
    gnorm_init: jax.Array
    f_opt: jax.Array
    gnorm_opt: jax.Array
    iterations: jax.Array
    accepted: jax.Array
    tcg_iters: jax.Array


def _tcg(
    qd: QuadraticData,
    X: jax.Array,
    S: jax.Array,
    grad: jax.Array,
    radius: jax.Array,
    max_inner: int,
    precision=None,
) -> TCGResult:
    """Preconditioned Steihaug-Toint truncated CG for
    min_eta <grad, eta> + 0.5 <eta, H eta>  s.t. ||eta||_P <= radius."""
    dtype = X.dtype
    zero = jnp.zeros_like(grad)

    r0 = grad
    z0 = quadratic.apply_precond(qd, X, r0, precision=precision)
    delta0 = -z0
    r_r0 = lifted.inner(r0, r0)
    z_r0 = lifted.inner(z0, r0)
    norm_r0 = jnp.sqrt(r_r0)
    # residual target: ||r|| <= ||r0|| * min(kappa, ||r0||^theta)
    r_target = norm_r0 * jnp.minimum(jnp.asarray(_KAPPA, dtype), norm_r0**_THETA)

    # carry: (j, eta, Heta, r, z, delta, e_Pe, e_Pd, d_Pd, z_r, done, boundary)
    def cond(c):
        j, *_, done, _ = c
        return jnp.logical_and(j < max_inner, jnp.logical_not(done))

    def body(c):
        j, eta, Heta, r, z, delta, e_Pe, e_Pd, d_Pd, z_r, done, boundary = c
        Hd = quadratic.rie_hess_vec(qd, X, S, delta, precision=precision)
        d_Hd = lifted.inner(delta, Hd)
        alpha = z_r / d_Hd
        e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd

        # negative curvature or leaving the trust region -> go to the boundary
        hit = jnp.logical_or(d_Hd <= 0.0, e_Pe_new >= radius * radius)
        disc = e_Pd * e_Pd + d_Pd * (radius * radius - e_Pe)
        tau = (-e_Pd + jnp.sqrt(jnp.maximum(disc, 0.0))) / d_Pd
        step = jnp.where(hit, tau, alpha)

        eta_n = eta + step * delta
        Heta_n = Heta + step * Hd

        r_n = r + alpha * Hd
        r_r_n = lifted.inner(r_n, r_n)
        resid_ok = jnp.sqrt(r_r_n) <= r_target

        z_n = quadratic.apply_precond(qd, X, r_n, precision=precision)
        z_r_n = lifted.inner(z_n, r_n)
        beta = z_r_n / z_r
        delta_n = -z_n + beta * delta
        e_Pd_n = beta * (e_Pd + alpha * d_Pd)
        d_Pd_n = z_r_n + beta * beta * d_Pd

        done_n = jnp.logical_or(hit, resid_ok)
        return (
            j + 1,
            eta_n,
            Heta_n,
            jnp.where(hit, r, r_n),
            jnp.where(hit, z, z_n),
            jnp.where(hit, delta, delta_n),
            jnp.where(hit, e_Pe, e_Pe_new),
            jnp.where(hit, e_Pd, e_Pd_n),
            jnp.where(hit, d_Pd, d_Pd_n),
            jnp.where(hit, z_r, z_r_n),
            done_n,
            jnp.logical_or(boundary, hit),
        )

    init = (
        jnp.asarray(0, jnp.int32), zero, zero, r0, z0, delta0,
        jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype), z_r0, z_r0,
        jnp.asarray(False), jnp.asarray(False),
    )
    if isinstance(max_inner, int) and max_inner <= _TCG_UNROLL:
        # masked unroll: same body, same order of operations for the
        # iterations that "run" (bit-identical to the while_loop result);
        # a step past `done` is computed and discarded by the where. NaNs
        # from 0/0 in a discarded step cannot leak: jnp.where selects, and
        # nothing here is differentiated.
        c = init
        for _ in range(max_inner):
            done_prev = c[-2]
            new = body(c)
            c = jax.tree.map(
                lambda o, n_: jnp.where(done_prev, o, n_), c, new
            )
        j, eta, Heta, *_, _done, boundary = c
    else:
        j, eta, Heta, *_, _done, boundary = jax.lax.while_loop(
            cond, body, init
        )
    return TCGResult(eta=eta, Heta=Heta, hit_boundary=boundary, num_iters=j)


def _rtr_iteration(qd, state: RTRState, max_inner: int, max_radius, shrink_only: bool,
                   qd_inner=None, exact_inner_hessian: bool = True,
                   inner_control_matvecs: bool = False,
                   residual_control: bool = False,
                   tcg_precision=None):
    """One outer RTR iteration: tCG, rho test, radius update.

    qd_inner: optionally a lower-precision copy of qd (mixed precision): the
    tCG inner loop — the hot path — runs in qd_inner's dtype while the
    trust-region control (cost, gradient, rho, retraction) stays in the outer
    dtype. (The reference is f64 throughout; the tCG tolerates reduced
    precision because the trust region bounds any step-quality loss, and
    f32 halves the bytes every matvec moves.)

    exact_inner_hessian: with mixed precision, recompute H(eta) in outer
    precision for the model decrease. The inner-precision H(eta) already
    gives the model decrease to f32 RELATIVE accuracy (no catastrophic
    cancellation: it is -(<g,eta> + 0.5<eta,Heta>) with same-order terms),
    which the 0.1/0.25/0.75 rho thresholds tolerate — so False skips one
    full-precision matvec per outer iteration. The actual-vs-predicted
    numerator (fx - f_new) stays in outer precision either way.
    """
    if qd_inner is not None:
        dt = qd_inner.diag.dtype
        tcg = _tcg(
            qd_inner,
            state.X.astype(dt),
            state.S.astype(dt),
            state.grad.astype(dt),
            state.radius.astype(dt),
            max_inner,
            precision=tcg_precision,
        )
        eta = lifted.proj_tangent(state.X, tcg.eta.astype(state.X.dtype))
        if exact_inner_hessian:
            Heta = quadratic.rie_hess_vec(qd, state.X, state.S, eta)
        else:
            Heta = tcg.Heta.astype(state.X.dtype)
        tcg = TCGResult(eta=eta, Heta=Heta, hit_boundary=tcg.hit_boundary,
                        num_iters=tcg.num_iters)
    else:
        tcg = _tcg(qd, state.X, state.S, state.grad, state.radius, max_inner,
                   precision=tcg_precision)
    X_new = lifted.retract(state.X, tcg.eta)
    if residual_control:
        # Residual-mode control: the new gradient comes from the
        # residual-form evaluator, and the cost decrease from the
        # exact-for-quadratics identity f(X')-f(X) = 0.5<step, g + g'> with
        # the Euclidean gradients carried in the state — both accurate to
        # ~eps·residual in the control dtype, so reference-quality (f64-
        # class) gradient norms are certifiable with pure-f32 tensor ops,
        # and no full q_matvec is needed.
        qd_c = qd if qd_inner is None else qd_inner
        dt = qd_c.diag.dtype
        hi = jax.lax.Precision.HIGHEST
        D = X_new - state.X
        _, eg_new = quadratic.cost_grad_residual(
            qd_c.res, X_new.astype(dt), precision=hi
        )
        eg = eg_new.astype(state.X.dtype)
        df = 0.5 * (lifted.inner(D, state.eg) + lifted.inner(D, eg))
        f_new = state.fx + df
    elif qd_inner is not None and inner_control_matvecs:
        # Cancellation-free actual decrease WITHOUT a full-precision matvec:
        # for the quadratic objective,
        #   f(X') - f(X) = 0.5 <(X + X') Q, X' - X> + <X' - X, G>.
        # The matvec runs in inner precision — its relative error is
        # contracted against the SMALL step difference D = X' - X, so the
        # decrease comes out to ~|XQ|*|D|*eps_inner absolute (f32: ~1e-9 at
        # unit scale) while a direct f(X') - f(X) subtraction would lose all
        # significant digits near convergence. The contractions and G stay
        # in outer precision.
        dt = qd_inner.diag.dtype
        hi = jax.lax.Precision.HIGHEST
        D = X_new - state.X
        # HIGHEST precision: these matvecs feed control decisions directly;
        # reduced-precision products (TF32 keeps ~3 decimal digits) are
        # tolerable inside the trust-region-bounded tCG but derail the
        # gradient.
        qs = quadratic.q_matvec(
            qd_inner, (state.X + X_new).astype(dt), precision=hi
        ).astype(state.X.dtype)
        df = 0.5 * lifted.inner(qs, D) + lifted.inner(D, qd.G)  # f(X_new) - f(X)
        f_new = state.fx + df
        # new Euclidean gradient from an inner-precision matvec: it feeds
        # only absolute-tolerance checks (gnorm), the next model decrease,
        # and the Weingarten correction — all true-f32-relative-tolerant.
        qm_new = quadratic.q_matvec(
            qd_inner, X_new.astype(dt), precision=hi
        ).astype(state.X.dtype)
        eg = qm_new + qd.G
    else:
        # one matvec serves both the new cost and the new Euclidean gradient:
        # f = 0.5 <XQ, X> + <X, G>,  eg = XQ + G
        qm_new = quadratic.q_matvec(qd, X_new)
        f_new = 0.5 * jnp.vdot(qm_new, X_new) + jnp.vdot(X_new, qd.G)
        eg = qm_new + qd.G

    model_decrease = -(lifted.inner(state.grad, tcg.eta) + 0.5 * lifted.inner(tcg.eta, tcg.Heta))
    if residual_control:
        # rho WITHOUT numerator inflation (mirrors delta._delta_rtr_step):
        # df is cancellation-free here, so a true cost increase must be
        # rejected — the cost-scaled reg below would accept noise steps near
        # convergence (up to ~1e3*eps*|fx|) which Nesterov then amplifies.
        # The denominator guard only avoids 0/0 (Steihaug decrease >= 0).
        rho = (state.fx - f_new) / jnp.maximum(
            model_decrease, jnp.finfo(state.fx.dtype).tiny
        )
    else:
        # small regularization guards rho against cancellation near
        # convergence (the direct f(X')-f(X) subtraction loses all digits)
        reg = 1e3 * jnp.finfo(state.fx.dtype).eps * jnp.maximum(1.0, jnp.abs(state.fx))
        rho = (state.fx - f_new + reg) / (model_decrease + reg)

    accept = rho > _RHO_PRIME
    if shrink_only:
        # Max_Iteration==1 mode: caller controls the radius (shrinks by 4 on
        # rejection); inside one Run() the radius is fixed.
        radius_new = state.radius
    else:
        radius_new = jnp.where(
            rho < 0.25,
            0.25 * state.radius,
            jnp.where(
                jnp.logical_and(rho > 0.75, tcg.hit_boundary),
                jnp.minimum(2.0 * state.radius, max_radius),
                state.radius,
            ),
        )

    X_next = jnp.where(accept, X_new, state.X)
    f_next = jnp.where(accept, f_new, state.fx)

    # on rejection the previous gradient/correction are still valid — select
    # instead of recomputing (saves a matvec on the rejected branch too)
    grad_new = lifted.proj_tangent(X_new, eg)
    S_new = quadratic.hess_correction(X_new, eg)
    grad_next = jnp.where(accept, grad_new, state.grad)
    S_next = jnp.where(accept, S_new, state.S)
    return RTRState(
        X=X_next,
        fx=f_next,
        grad=grad_next,
        gnorm=lifted.norm(grad_next),
        S=S_next,
        eg=jnp.where(accept, eg, state.eg),
        radius=radius_new,
        it=state.it + 1,
        accepted=accept,
        tcg_iters=state.tcg_iters + tcg.num_iters,
    )


def _initial_state(qd, Y0, radius, qd_inner=None, inner_control_matvecs=False,
                   residual_control=False):
    # one matvec for both cost and gradient (f = 0.5 <XQ,X> + <X,G>). With
    # inner control matvecs the initial cost/gradient run in inner precision:
    # fx only anchors the running decrease (differences are computed
    # cancellation-free, see _rtr_iteration) and the gradient feeds
    # absolute-tolerance checks.
    if residual_control:
        # residual-form cost + gradient: cancellation-free in the control
        # dtype (fx is in the complete-residual convention — constant-offset
        # from 0.5<XQ,X>+<X,G>, which cancels in every decision)
        qd_c = qd if qd_inner is None else qd_inner
        dt = qd_c.diag.dtype
        f0, eg = quadratic.cost_grad_residual(
            qd_c.res, Y0.astype(dt), precision=jax.lax.Precision.HIGHEST
        )
        eg = eg.astype(Y0.dtype)
        grad = lifted.proj_tangent(Y0, eg)
        return RTRState(
            X=Y0,
            fx=f0.astype(Y0.dtype),
            grad=grad,
            gnorm=lifted.norm(grad),
            S=quadratic.hess_correction(Y0, eg),
            eg=eg,
            radius=jnp.asarray(radius, Y0.dtype),
            it=jnp.asarray(0, jnp.int32),
            accepted=jnp.asarray(False),
            tcg_iters=jnp.asarray(0, jnp.int32),
        )
    if qd_inner is not None and inner_control_matvecs:
        dt = qd_inner.diag.dtype
        qm = quadratic.q_matvec(
            qd_inner, Y0.astype(dt), precision=jax.lax.Precision.HIGHEST
        ).astype(Y0.dtype)
    else:
        qm = quadratic.q_matvec(qd, Y0)
    eg = qm + qd.G
    grad = lifted.proj_tangent(Y0, eg)
    return RTRState(
        X=Y0,
        fx=0.5 * jnp.vdot(qm, Y0) + jnp.vdot(Y0, qd.G),
        grad=grad,
        gnorm=lifted.norm(grad),
        S=quadratic.hess_correction(Y0, eg),
        eg=eg,
        radius=jnp.asarray(radius, Y0.dtype),
        it=jnp.asarray(0, jnp.int32),
        accepted=jnp.asarray(False),
        tcg_iters=jnp.asarray(0, jnp.int32),
    )


@partial(
    jax.jit,
    static_argnames=("max_iterations", "max_inner", "shrink_until_accept",
                     "inner_dtype", "exact_inner_hessian",
                     "inner_control_matvecs", "residual_control",
                     "tcg_precision"),
)
def rtr_solve(
    qd: QuadraticData,
    Y0: jax.Array,
    gradnorm_tol: float,
    initial_radius: float,
    max_iterations: int = 3,
    max_inner: int = 50,
    shrink_until_accept: bool = False,
    inner_dtype=None,
    exact_inner_hessian: bool = True,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
    tcg_precision=None,
) -> Tuple[jax.Array, RTRStats]:
    """Riemannian trust-region solve of the lifted PGO quadratic.

    With shrink_until_accept=True this reproduces the reference's per-RBCD-step
    mode (QuadraticOptimizer.cpp:80-98): a single RTR iteration retried with
    radius/4 until acceptance (max 10 shrinks, else the initial iterate is
    returned). Otherwise it runs a standard RTR loop for up to max_iterations.

    inner_dtype (e.g. jnp.float32): run the tCG inner loop in reduced
    precision while keeping trust-region control in Y0's dtype — see
    _rtr_iteration. None = single precision level throughout.

    tcg_precision: matmul precision for the tCG inner loop (None or
    jax.lax.Precision.HIGHEST). With None a GPU may run f32 products in
    TF32 — with an f64 (or mixed) control loop the trust region absorbs the
    resulting step-quality loss, but in the PURE-f32 certified path a
    reduced-precision Hessian can floor the reachable gradient norm above
    the target — pass HIGHEST there. f64 inputs are unaffected.

    residual_control=True (requires qd.res, see quadratic.ResidualData):
    control cost differences come from the cancellation-free identity and
    control gradients from the residual-form evaluator — both accurate to
    ~eps·residual in the control dtype, so reference-quality gradient norms
    are certifiable without any f64 tensor kernels (the scale path).
    """
    qd_inner = None
    if inner_dtype is not None and inner_dtype != Y0.dtype:
        cast = lambda x: x.astype(inner_dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x
        qd_inner = jax.tree.map(cast, qd)
    state0 = _initial_state(qd, Y0, initial_radius, qd_inner,
                            inner_control_matvecs, residual_control)
    f_init, g_init = state0.fx, state0.gnorm
    # No optimization if gradient is already below threshold
    # (QuadraticOptimizer.cpp:56-58).
    skip = state0.gnorm < gradnorm_tol

    if shrink_until_accept:
        def cond(c):
            state, attempts = c
            return jnp.logical_and(
                jnp.logical_not(state.accepted), attempts <= _MAX_SHRINKS
            )

        def body(c):
            state, attempts = c
            nxt = _rtr_iteration(qd, state, max_inner, max_radius=state.radius,
                                 shrink_only=True, qd_inner=qd_inner,
                                 exact_inner_hessian=exact_inner_hessian,
                                 inner_control_matvecs=inner_control_matvecs,
                                 residual_control=residual_control,
                                 tcg_precision=tcg_precision)
            # on rejection: keep the original iterate, shrink the radius by 4
            nxt = nxt._replace(
                radius=jnp.where(nxt.accepted, nxt.radius, 0.25 * state.radius)
            )
            return nxt, attempts + 1

        final, _ = jax.lax.while_loop(
            cond, body, (state0, jnp.asarray(0, jnp.int32))
        )
    else:
        max_radius = 5.0 * jnp.asarray(initial_radius, Y0.dtype)

        def cond(state):
            return jnp.logical_and(
                state.it < max_iterations, state.gnorm >= gradnorm_tol
            )

        def body(state):
            return _rtr_iteration(qd, state, max_inner, max_radius,
                                  shrink_only=False, qd_inner=qd_inner,
                                  exact_inner_hessian=exact_inner_hessian,
                                  inner_control_matvecs=inner_control_matvecs,
                                  residual_control=residual_control,
                                  tcg_precision=tcg_precision)

        final = jax.lax.while_loop(cond, body, state0)

    X_out = jnp.where(skip, Y0, final.X)
    stats = RTRStats(
        f_init=f_init,
        gnorm_init=g_init,
        f_opt=jnp.where(skip, f_init, final.fx),
        gnorm_opt=jnp.where(skip, g_init, final.gnorm),
        iterations=jnp.where(skip, 0, final.it),
        accepted=jnp.where(skip, True, final.accepted),
        tcg_iters=final.tcg_iters,
    )
    return X_out, stats


def rtr_solve_auto(
    problem,
    X0: jax.Array,
    gradnorm_tol: float,
    initial_radius: float = 100.0,
    max_iterations: int = 100,
    max_inner: int = 200,
    probe_iterations: int = 15,
    inner_dtype=None,
    precond_shift: float = None,
    **solve_kwargs,
) -> Tuple[jax.Array, RTRStats]:
    """Centralized solve with MEASURED (wall-time-aware) preconditioner
    selection — the production driver for full-batch solves.

    Phase 1 runs up to `probe_iterations` outer RTR iterations with the
    cheap block-Jacobi preconditioner (one batched (dh,dh) matmul per tCG
    application). Well-conditioned problems (sphere2500 class) converge here
    and never pay for an exact factor — neither its factorization nor its
    ~s-fold per-application cost (s = RCM superblock bandwidth).

    Phase 2 runs ONLY on a measured stall (phase 1 ends above tol): rebuild
    with the exact banded factor (RCM + superblock cyclic reduction,
    ops/block_tridiag.py — Cholmod-LDL^T parity with the reference's
    PoseGraph.cpp:598-613) and continue from the phase-1 iterate.
    Ill-conditioned problems (ais2klinik class) pay the factor cost only
    because Jacobi demonstrably failed.

    The selection is by measurement because prediction is impossible from
    graph structure alone: the exact factor cuts sphere2500's tCG iteration
    count ~6x yet cost more wall time there, while on ais2klinik (smaller
    bandwidth!) it is the difference between convergence and a multi-hour
    stall.
    """
    import numpy as _np

    from dpgo_tpu import quadratic as _q

    r = int(X0.shape[-2])
    dh = int(X0.shape[-1])
    shift_kw = {} if precond_shift is None else {"precond_shift": precond_shift}
    zeros_nbr = jnp.zeros((1, r, dh), X0.dtype)

    def _build(precond):
        return _q.build_quadratic_data(problem, zeros_nbr, r=r,
                                       precond=precond, **shift_kw)

    probe = min(probe_iterations, max_iterations)
    qd1 = _build("jacobi")
    X, stats = rtr_solve(
        qd1, X0, gradnorm_tol, initial_radius,
        max_iterations=probe, max_inner=max_inner,
        inner_dtype=inner_dtype, **solve_kwargs,
    )
    gn = float(stats.gnorm_opt)
    if gn < gradnorm_tol or probe >= max_iterations:
        return X, stats

    # measured stall: escalate to the exact factor and continue
    qd2 = _build("banded")
    X2, stats2 = rtr_solve(
        qd2, X, gradnorm_tol, initial_radius,
        max_iterations=max_iterations - probe, max_inner=max_inner,
        inner_dtype=inner_dtype, **solve_kwargs,
    )
    merged = RTRStats(
        f_init=stats.f_init,
        gnorm_init=stats.gnorm_init,
        f_opt=stats2.f_opt,
        gnorm_opt=stats2.gnorm_opt,
        iterations=stats.iterations + stats2.iterations,
        accepted=stats2.accepted,
        tcg_iters=stats.tcg_iters + stats2.tcg_iters,
    )
    return X2, merged


def initial_cost_gradnorm(
    qd: QuadraticData,
    Y0: jax.Array,
    inner_dtype=None,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Cost and Riemannian gradient norm at Y0, computed exactly as
    rtr_solve's gnorm_init/f_init under the same control-path flags (one
    matvec / one residual pass — no solve). Lets callers evaluate selection
    and termination metrics for agents that do NOT optimize this round
    without paying for a discarded trust-region solve (the reference's
    central evaluation, MultiRobotExample.cpp:233-247)."""
    qd_inner = None
    if inner_dtype is not None and inner_dtype != Y0.dtype:
        cast = lambda x: (
            x.astype(inner_dtype)
            if jnp.issubdtype(x.dtype, jnp.floating) else x
        )
        qd_inner = jax.tree.map(cast, qd)
    st = _initial_state(qd, Y0, 0.0, qd_inner, inner_control_matvecs,
                        residual_control)
    return st.fx, st.gnorm


@jax.jit
def rgd_step(
    qd: QuadraticData,
    Y0: jax.Array,
    stepsize: float,
    use_preconditioner: bool = True,
) -> jax.Array:
    """One preconditioned Riemannian gradient step with retraction
    (reference: QuadraticOptimizer.cpp:110-137)."""
    g = quadratic.rie_grad(qd, Y0)
    direction = jnp.where(
        use_preconditioner, quadratic.apply_precond(qd, Y0, g), g
    )
    return lifted.retract(Y0, -stepsize * direction)


@partial(jax.jit, static_argnames=("max_iterations",))
def rsd_line_search(
    qd: QuadraticData,
    Y0: jax.Array,
    gradnorm_tol: float = 1e-2,
    max_iterations: int = 10,
    initial_step: float = 1.0,
    backtrack: float = 0.5,
    armijo: float = 1e-4,
    max_backtracks: int = 20,
) -> Tuple[jax.Array, RTRStats]:
    """Riemannian steepest descent with Armijo backtracking line search — the
    counterpart of the reference's (unused) ROPTLIB::RSD path
    (QuadraticOptimizer.cpp:139-160: tol 1e-2, 10 iterations)."""

    def body(state):
        X, fx, grad, gnorm, it = state

        def ls_cond(c):
            t, f_new, X_new, k = c
            armijo_ok = f_new <= fx - armijo * t * gnorm**2
            return jnp.logical_and(jnp.logical_not(armijo_ok), k < max_backtracks)

        def ls_body(c):
            t, _, _, k = c
            t = t * backtrack
            X_new = lifted.retract(X, -t * grad)
            return (t, quadratic.cost(qd, X_new), X_new, k + 1)

        t0 = jnp.asarray(initial_step, X.dtype)
        X_try = lifted.retract(X, -t0 * grad)
        t, f_new, X_new, _ = jax.lax.while_loop(
            ls_cond, ls_body, (t0, quadratic.cost(qd, X_try), X_try, 0)
        )
        accept = f_new < fx
        X_next = jnp.where(accept, X_new, X)
        f_next = jnp.where(accept, f_new, fx)
        g_next = quadratic.rie_grad(qd, X_next)
        return (X_next, f_next, g_next, lifted.norm(g_next), it + 1)

    g0 = quadratic.rie_grad(qd, Y0)
    state0 = (Y0, quadratic.cost(qd, Y0), g0, lifted.norm(g0),
              jnp.asarray(0, jnp.int32))
    f_init, g_init = state0[1], state0[3]

    def cond(state):
        return jnp.logical_and(state[4] < max_iterations, state[3] >= gradnorm_tol)

    X, fx, _, gnorm, it = jax.lax.while_loop(cond, body, state0)
    stats = RTRStats(
        f_init=f_init, gnorm_init=g_init, f_opt=fx, gnorm_opt=gnorm,
        iterations=it, accepted=jnp.asarray(True),
        tcg_iters=jnp.asarray(0, jnp.int32),
    )
    return X, stats


def optimize(qd: QuadraticData, Y0: jax.Array, params: ROptParameters):
    """Dispatch mirroring QuadraticOptimizer::optimize (reference:
    QuadraticOptimizer.cpp:26-48). Returns (Yopt, RTRStats)."""
    from dpgo_tpu.types import ROptMethod

    if params.method == ROptMethod.RTR:
        return rtr_solve(
            qd,
            Y0,
            gradnorm_tol=params.gradnorm_tol,
            initial_radius=params.RTR_initial_radius,
            max_iterations=params.RTR_iterations,
            max_inner=params.RTR_tCG_iterations,
            shrink_until_accept=(params.RTR_iterations == 1),
        )
    Y = rgd_step(qd, Y0, params.RGD_stepsize, params.RGD_use_preconditioner)
    stats = RTRStats(
        f_init=quadratic.cost(qd, Y0),
        gnorm_init=quadratic.rie_grad_norm(qd, Y0),
        f_opt=quadratic.cost(qd, Y),
        gnorm_opt=quadratic.rie_grad_norm(qd, Y),
        iterations=jnp.asarray(1, jnp.int32),
        accepted=jnp.asarray(True),
        tcg_iters=jnp.asarray(0, jnp.int32),
    )
    return Y, stats
