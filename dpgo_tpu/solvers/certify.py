"""Global-optimality certification + the Riemannian staircase (matrix-free).

The reference implements the algorithms of Tian et al., *Distributed
Certifiably Correct Pose-Graph Optimization* (T-RO 2021) — rank-lifted RBCD —
but the repository itself never evaluates the certificate: it terminates on
gradient norm alone (`/root/reference/src/PGOAgent.cpp:846-878`) and relies
on the rank lift r > d for correctness in theory. This module supplies the
missing capability the papers name: an SE-Sync / Cartan-Sync style dual
certificate, evaluated matrix-free so it runs on the same blocked-sparse
`q_matvec` the solvers use (batched dense blocks, no sparse factorization).

Math. The centralized lifted problem (every edge private, no linear term) is

    min f(X) = 0.5 <X Q, X>,   X in (St(d,r) x R^r)^n,

with X stored (n, r, d+1) row-major (math form: r x (d+1)n). At a
first-order critical point the KKT multipliers of the per-pose orthonormality
constraints Y_i^T Y_i = I are

    Lambda_i = sym(Y_i^T (X Q)_i^rot)          (d x d, symmetric),

and the translation gradient (X Q)_i^trans vanishes. Let LambdaHat be the
(d+1)n x (d+1)n block-diagonal with [Lambda_i, 0] on pose i's diagonal
block. The certificate matrix

    S = Q - LambdaHat

satisfies X S = 0 at the critical point, and

    S >= 0  (PSD)  ==>  Z = X^T X solves the SDP relaxation, so X is a
                        GLOBAL minimizer of the rank-r problem;
                        if additionally rank(X) = d, rounding X yields the
                        global SE(d) optimum.

(Boumal-Voroninski-Bandeira low-rank SDP theory; SE-Sync Props. 2 & 11;
Cartan-Sync for the (d+1)-block connection-Laplacian form used here.)
If lambda_min(S) < 0 with eigenvector v, the rank-(r+1) lift
X+ = [X; eps v^T] is a second-order descent direction — the staircase
escape: f decreases by ~0.5 eps^2 lambda_min after retraction.

Notes
-----
* S always annihilates the global-translation vector (w_i = (0_d, 1)):
  Q w = 0 for a connected anchor-free graph and LambdaHat is zero on the
  translation entry — so lambda_min(S) <= 0 with equality at optimality.
  The test is lambda_min >= -eta for a small eta.
* The certificate is for the GLOBAL problem. To certify a distributed
  (multi-agent) solution, assemble the global iterate and build the
  centralized evaluation problem over ALL measurements
  (`quadratic.from_private_measurements` on the full edge set), exactly like
  `parallel/simulation.build_central_evaluation`.
* lambda_min is computed by Lanczos with full reorthogonalization on the
  matrix-free S-action — one `q_matvec` plus one batched (n,d,d) einsum per
  iteration, all jit-compiled; the k x k tridiagonal eigenproblem is solved
  on the host (k <= ~160 scalars).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu import quadratic
from dpgo_tpu.ops import lifted

_HI = jax.lax.Precision.HIGHEST


def kkt_multipliers(qd: quadratic.QuadraticData, X: jax.Array) -> jax.Array:
    """Lambda_i = sym(Y_i^T (XQ + G)_i^rot): (n, d, d).

    The linear term G is included so the multipliers are exact for local
    (agent) problems too; for the centralized certificate G = 0."""
    eg = quadratic.euc_grad(qd, X)
    YtG = jnp.einsum(
        "nra,nrb->nab", lifted.rotations(X), lifted.rotations(eg),
        precision=_HI,
    )
    return 0.5 * (YtG + jnp.swapaxes(YtG, -1, -2))


def certificate_matvec(
    qd: quadratic.QuadraticData, Lam: jax.Array, V: jax.Array
) -> jax.Array:
    """Row-action v S = v Q - v LambdaHat for V: (n, k, dh) (k arbitrary;
    the eigen-solver uses k = 1). Matrix-free: one q_matvec + one batched
    small einsum."""
    VQ = quadratic.q_matvec(qd, V, precision=_HI)
    corr = jnp.einsum(
        "nka,nab->nkb", lifted.rotations(V), Lam, precision=_HI
    )
    return VQ - jnp.concatenate(
        [corr, jnp.zeros_like(lifted.translations(V)[..., None])], axis=-1
    )


def stationarity_gap(
    qd: quadratic.QuadraticData, X: jax.Array, Lam: jax.Array
) -> jax.Array:
    """|| X S ||_F — how far X is from a true critical point. The
    certificate is meaningful only when this is small (it equals the
    Riemannian gradient norm up to the symmetric-part split)."""
    return lifted.norm(certificate_matvec(qd, Lam, X))


def _lanczos(matvec, v0: jax.Array, k: int):
    """k-step Lanczos with FULL reorthogonalization (jit-compiled).

    matvec: (m,) -> (m,) symmetric operator action. Returns
    (alpha (k,), beta (k,), V (k, m)); beta[-1] is the final residual norm.
    Full reorthogonalization keeps the extreme Ritz values trustworthy at
    f32/f64 alike — k is small, so the k x m storage is cheap."""
    m = v0.shape[0]
    dt = v0.dtype
    v0 = v0 / jnp.linalg.norm(v0)

    def body(i, carry):
        V, alpha, beta, v, b_prev = carry
        V = V.at[i].set(v)
        w = matvec(v)
        a = jnp.vdot(v, w)
        w = w - a * v - jnp.where(i > 0, b_prev, 0.0) * V[jnp.maximum(i - 1, 0)]
        # full reorthogonalization against all vectors so far (rows > i are
        # zero, so the masked sum is exact); twice is enough (Parlett)
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        b = jnp.linalg.norm(w)
        alpha = alpha.at[i].set(a)
        beta = beta.at[i].set(b)
        v_next = jnp.where(b > 1e-12, w / jnp.maximum(b, 1e-30), w)
        return (V, alpha, beta, v_next, b)

    V0 = jnp.zeros((k, m), dt)
    alpha0 = jnp.zeros((k,), dt)
    beta0 = jnp.zeros((k,), dt)
    V, alpha, beta, _v, _b = jax.lax.fori_loop(
        0, k, body, (V0, alpha0, beta0, v0, jnp.zeros((), dt))
    )
    return alpha, beta, V


def _pcg_refine_min(mv, prec, defl, x0, iters: int, tol: float):
    """Preconditioned Rayleigh-quotient minimization (LOBPCG, block 1) for
    the smallest eigenpair of the deflated certificate operator.

    Plain Lanczos stalls on large graphs: the bottom of the deflated
    spectrum sits under a tiny relative gap (~5e-3 / 1.2e3 on sphere2500) and
    the Ritz residual decays only ~2x per doubled k. The SPD preconditioner
    the tCG already owns — (Q + shift I)^{-1}, exact banded or block-Jacobi —
    is a near-inverse of S = Q - LambdaHat, so the preconditioned iteration
    converges in tens of matvecs. Host-driven loop; mv/prec are jitted
    device calls.

    Returns (theta, x, residual_norm): the RAYLEIGH QUOTIENT and exact
    residual of the returned vector — the rigorous ingredients of the bound
    lambda_min >= theta - ||r||."""
    x = np.array(defl(x0), np.float64)
    x /= np.linalg.norm(x)
    p = None
    for _ in range(iters):
        Sx = np.asarray(mv(x), np.float64)
        theta = float(x @ Sx)
        r = Sx - theta * x
        rn = float(np.linalg.norm(r))
        if rn < tol:
            return theta, x, rn
        w = np.asarray(defl(prec(r)), np.float64)
        cols = [x, w] if p is None else [x, w, p]
        Bq, _ = np.linalg.qr(np.stack(cols, axis=1))
        SB = np.stack(
            [np.asarray(mv(Bq[:, i]), np.float64)
             for i in range(Bq.shape[1])], axis=1,
        )
        T = Bq.T @ SB
        T = 0.5 * (T + T.T)
        _evals, evecs = np.linalg.eigh(T)
        y = evecs[:, 0]
        x_new = Bq @ y
        # LOBPCG history direction: the part of the step orthogonal to x
        p = x_new - x * float(x @ x_new)
        pn = np.linalg.norm(p)
        p = p / pn if pn > 1e-12 else None
        x = x_new / np.linalg.norm(x_new)
    Sx = np.asarray(mv(x), np.float64)
    theta = float(x @ Sx)
    rn = float(np.linalg.norm(Sx - theta * x))
    return theta, x, rn


class CertificateResult(NamedTuple):
    certified: bool
    lambda_min: float  # point estimate: min over both subspaces
    lambda_min_lower: float  # rigorous lower bound on lambda_min(S)
    eigvec: np.ndarray  # (n, dh) unit vector: most-negative direction found
    stationarity: float  # ||X S||_F at the tested point
    eig_residual: float  # Lanczos residual of the deflated Ritz pair


def min_eig_certificate(
    qd: quadratic.QuadraticData,
    X: jax.Array,
    k: int = 64,
    eta: float = 1e-6,
    seed: int = 0,
    refine_iters: int = 400,
    seeds: Optional[Tuple[int, ...]] = None,
) -> CertificateResult:
    """lambda_min(S) via DEFLATED matrix-free Lanczos.

    Soundness caveat (standard for iterative certificates, SE-Sync
    included): the bound lambda >= theta - ||r|| is rigorous for the
    eigenvalue NEAREST theta; it bounds lambda_min only when the returned
    pair approximates the BOTTOM of the deflated spectrum. Random-start
    Lanczos with full reorthogonalization plus the monotone Rayleigh-
    quotient refinement makes convergence onto an interior eigenvalue a
    measure-zero event (it requires the start to have numerically zero
    overlap with the bottom eigenvector), but it is not a proof. Pass
    seeds=(0, 1, ...) to re-run from independent starts and take the
    worst-case result.

    At a critical point S annihilates the entire row space of X
    (stationarity: X S = 0) plus the translation-gauge vector — a
    (rank(X)+?)-dimensional cluster of zero eigenvalues sitting exactly at
    the decision boundary, where plain Lanczos converges arbitrarily slowly.
    Deflate B = orthonormal basis of span{rows(X), gauge} and Lanczos the
    complement P S P (P = I - B Bᵀ), where the spectrum has a genuine gap.

    Splitting R^m = span(B) ⊕ span(B)^⊥ gives the rigorous bound

        lambda_min(S) >= min(lambda_min(BᵀSB), lambda_defl - res) - ||PSB||

    (Weyl on the 2x2 block form; the coupling ||PSB|| ~ stationarity error,
    ~0 at convergence). The certificate passes when the bound is >= -eta.
    Dominant cost: k+q+1 q_matvecs, all jit-compiled."""
    if seeds is not None:
        results = [
            min_eig_certificate(qd, X, k=k, eta=eta, seed=s,
                                refine_iters=refine_iters)
            for s in seeds
        ]
        return min(results, key=lambda c: c.lambda_min_lower)
    n, r, dh = X.shape
    d = dh - 1
    m = n * dh
    Lam = kkt_multipliers(qd, X)

    def mv(w):
        return certificate_matvec(
            qd, Lam, w.reshape(n, 1, dh)
        ).reshape(m)

    # deflation basis: rows of X + the translation-gauge vector, QR'd
    gauge = np.zeros((1, n, dh))
    gauge[0, :, d] = 1.0
    raw = np.concatenate(
        [np.asarray(X, np.float64).transpose(1, 0, 2).reshape(r, m),
         gauge.reshape(1, m)], axis=0
    )
    # SVD basis, NOT QR: for a rank-deficient stack (rank(X) = d at a tight
    # solution, so 5 rows span 3 dims) unpivoted QR emits garbage Q columns
    # outside the row span, which are not S-null and wreck the coupling
    # bound. Right-singular vectors always lie in the span; small-sigma
    # directions are noise-dominated and redundant — drop them.
    _u, sv, Vt = np.linalg.svd(raw, full_matrices=False)
    B = jnp.asarray(Vt[sv > 1e-6 * sv[0]], X.dtype)  # (q, m) orthonormal
    q = B.shape[0]
    k = int(min(k, m - q))

    def mv_defl(w):
        w = w - B.T @ (B @ w)
        u = mv(w)
        return u - B.T @ (B @ u)

    key = jax.random.PRNGKey(seed)
    v0 = jax.random.normal(key, (m,), X.dtype)
    v0 = v0 - B.T @ (B @ v0)
    alpha, beta, V = jax.jit(
        lambda v0_: _lanczos(mv_defl, v0_, k)
    )(v0)
    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64)
    # Lanczos breakdown (invariant subspace found): truncate at the first
    # tiny beta, else the zero rows of T would contribute spurious 0 eigs.
    small = np.nonzero(beta < 1e-10)[0]
    if small.size:
        k = int(small[0]) + 1
        alpha, beta = alpha[:k], beta[:k]
    T = np.diag(alpha)
    off = beta[: k - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    lam_defl = float(evals[0])
    y = evecs[:, 0]
    v = np.asarray(V, np.float64)[:k].T @ y
    v /= np.linalg.norm(v)
    v_dev = jnp.asarray(v, X.dtype)
    res = float(jnp.linalg.norm(mv_defl(v_dev) - lam_defl * v_dev))

    # Refine with the preconditioned Rayleigh-quotient iteration when the
    # Lanczos residual is too large for the rigorous bound (large graphs:
    # tiny relative spectral gap). Uses the quadratic data's own SPD
    # preconditioner (Q + shift I)^{-1}.
    res_target = max(0.1 * eta, 1e-10)
    if res > res_target and refine_iters > 0:
        mv_j = jax.jit(mv_defl)

        def prec(w):
            return quadratic.precond_solve(
                qd, jnp.asarray(w, X.dtype).reshape(n, 1, dh)
            ).reshape(m)

        def defl(w):
            w = jnp.asarray(w, X.dtype)
            return w - B.T @ (B @ w)

        lam_r, v_r, res_r = _pcg_refine_min(
            mv_j, jax.jit(prec), jax.jit(defl), v,
            iters=refine_iters, tol=res_target,
        )
        if lam_r - res_r > lam_defl - res:  # keep the better bound
            lam_defl, v, res = lam_r, v_r, res_r

    # the q x q restriction and the coupling block
    SBt = jax.vmap(mv)(B)  # (q, m) rows = S b_i
    M_B = np.asarray(B @ SBt.T, np.float64)
    M_B = 0.5 * (M_B + M_B.T)
    lam_B = float(np.linalg.eigvalsh(M_B)[0]) if q else np.inf
    PSB = np.asarray(SBt - (SBt @ B.T) @ B, np.float64)  # (q, m) = (P S b_i)ᵀ
    coupling = float(np.linalg.norm(PSB, 2)) if q else 0.0

    lam_est = min(lam_defl, lam_B)
    lam_lower = min(lam_B, lam_defl - res) - coupling
    stat = float(stationarity_gap(qd, X, Lam))
    return CertificateResult(
        certified=bool(lam_lower >= -eta),
        lambda_min=lam_est,
        lambda_min_lower=lam_lower,
        eigvec=v.reshape(n, dh),
        stationarity=stat,
        eig_residual=res,
    )


def lift_and_escape(
    X: jax.Array, eigvec: np.ndarray, lambda_min: float,
    qd_next: quadratic.QuadraticData, max_backtracks: int = 20,
) -> jax.Array:
    """Rank lift r -> r+1 along the negative-curvature direction.

    X+ = project([X; eps v^T]) with eps backtracked until the cost at the
    NEXT rank (qd_next, built at r+1) strictly decreases — guaranteed for
    small eps since the second-order decrease is 0.5 eps^2 lambda_min < 0
    (SE-Sync Alg. 2 "Riemannian staircase" escape)."""
    n, r, dh = X.shape
    v = jnp.asarray(eigvec, X.dtype).reshape(n, 1, dh)
    X_pad = jnp.concatenate([X, jnp.zeros((n, 1, dh), X.dtype)], axis=1)
    f0 = float(quadratic.cost(qd_next, X_pad))
    eps = 1.0
    for _ in range(max_backtracks):
        Xp = lifted.project_lifted(
            X_pad.at[:, r: r + 1, :].add(eps * v)
        )
        if float(quadratic.cost(qd_next, Xp)) < f0 - 1e-15:
            return Xp
        eps *= 0.5
    # no decreasing step found (the direction's second-order model did not
    # hold — e.g. the certificate was evaluated away from a true critical
    # point): return the PLAIN lift, whose cost equals f0 exactly, never a
    # cost-increasing iterate
    return X_pad


def certify_solution(
    measurements: Sequence,
    X: jax.Array,
    k: int = 64,
    eta: float = 1e-6,
    precond: str = "auto",
    refine_iters: int = 400,
) -> CertificateResult:
    """Certify a GLOBAL iterate (n, r, dh) against the full measurement set —
    the entry point for distributed solutions: assemble the team's global
    trajectory (spmd.assemble_global / PGOAgent outputs lifted) and test the
    centralized certificate on it. The distributed protocol never needs the
    global problem; this is an offline verification step, exactly the role
    the certificate plays in SE-Sync."""
    from dpgo_tpu.measurements import EdgeArrays
    from dpgo_tpu.solvers.pgo import num_poses_and_dim

    d, n = num_poses_and_dim(measurements)
    r = X.shape[-2]
    assert X.shape == (n, r, d + 1), (X.shape, (n, r, d + 1))
    edges = EdgeArrays.from_measurements(measurements)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    qd = quadratic.build_quadratic_data(
        problem, jnp.zeros((1, r, d + 1)), r=r, precond=precond
    )
    return min_eig_certificate(
        qd, jnp.asarray(X), k=k, eta=eta, refine_iters=refine_iters
    )


class StaircaseResult(NamedTuple):
    X: np.ndarray  # (n, r_final, d+1) certified (or last) iterate
    r: int
    certified: bool
    lambda_min: float
    cost: float
    gradnorm: float
    history: tuple


def solve_pgo_staircase(
    measurements: Sequence,
    r0: Optional[int] = None,
    r_max: int = 10,
    gradnorm_tol: float = 1e-6,
    eta: float = 1e-6,
    max_iterations: int = 200,
    max_inner: int = 200,
    T0: Optional[np.ndarray] = None,
    lanczos_k: int = 96,
    verbose: bool = False,
) -> StaircaseResult:
    """Certifiably-correct centralized PGO: solve at rank r, test the dual
    certificate, escape to rank r+1 along the negative eigenvector until
    certified (the SE-Sync Riemannian staircase, absent from the reference).

    Returns the certified lifted iterate; round it with
    `lifted.project_rotation` / the agent rounding path as usual."""
    from dpgo_tpu.measurements import EdgeArrays
    from dpgo_tpu.solvers import rtr as rtr_mod
    from dpgo_tpu.solvers.pgo import chordal_initialization, num_poses_and_dim

    d, n = num_poses_and_dim(measurements)
    r0 = d if r0 is None else r0
    assert r0 >= d
    edges = EdgeArrays.from_measurements(measurements)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)

    if T0 is None:
        T0 = chordal_initialization(measurements)
    T0 = np.asarray(T0)

    def qd_at(r):
        return quadratic.build_quadratic_data(
            problem, jnp.zeros((1, r, d + 1)), r=r
        )

    # lift the d-rank init to r0
    if r0 == d:
        X = jnp.asarray(T0)
    else:
        Y = np.asarray(lifted.fixed_stiefel_variable(d, r0))
        X = jnp.asarray(np.einsum("rd,nde->nre", Y, T0))

    history = []
    r = r0
    while True:
        qd = qd_at(r)
        X, stats = rtr_mod.rtr_solve(
            qd, X, gradnorm_tol=gradnorm_tol, initial_radius=100.0,
            max_iterations=max_iterations, max_inner=max_inner,
        )
        cert = min_eig_certificate(qd, X, k=lanczos_k, eta=eta)
        rec = {
            "r": r, "cost": 2 * float(stats.f_opt),
            "gradnorm": float(stats.gnorm_opt),
            "lambda_min": cert.lambda_min,
            "certified": cert.certified,
        }
        history.append(rec)
        if verbose:
            print(f"staircase r={r}: cost={rec['cost']:.6f} "
                  f"gn={rec['gradnorm']:.2e} "
                  f"lambda_min={cert.lambda_min:.3e} "
                  f"certified={cert.certified}", flush=True)
        if cert.certified or r >= r_max:
            return StaircaseResult(
                X=np.asarray(X), r=r, certified=cert.certified,
                lambda_min=cert.lambda_min, cost=rec["cost"],
                gradnorm=rec["gradnorm"], history=tuple(history),
            )
        qd_next = qd_at(r + 1)
        X = lift_and_escape(X, cert.eigvec, cert.lambda_min, qd_next)
        r += 1
