"""The lifted PGO quadratic problem  f(X) = 0.5 <X Q, X> + <X, G>.

Array-native replacement of the reference's PoseGraph data matrices +
QuadraticProblem (reference: src/PoseGraph.cpp:381-613,
src/QuadraticProblem.cpp:29-83). Instead of materializing the connection
Laplacian Q as a scalar sparse matrix (Eigen::SparseMatrix + Cholmod), we keep
its (d+1)x(d+1) block structure explicitly:

  Q = A Omega A^T  for the block incidence A (block col k: -T_k at tail i,
  I at head j) and Omega_k = diag(w*kappa ... w*kappa, w*tau), so per edge k:

    Q_ii += T_k Omega_k T_k^T      Q_ij += -T_k Omega_k = -E_k
    Q_jj += Omega_k                Q_ji += -E_k^T

Shared (inter-robot) edges contribute only diagonal blocks to the local Q
(PoseGraph.cpp:395-459) plus the linear term G built from cached neighbor
poses (PoseGraph.cpp:493-580). Priors add diagonal blocks and linear terms
with kappa=1e4 / tau=1e2 (PoseGraph.cpp:17-18).

The Hessian-vector product (X Q) — the innermost op of every tCG iteration
(QuadraticProblem.cpp:49-54) — becomes: one batched (r,dh)x(dh,dh) matmul
against the diagonal blocks + two gathered batched matmuls and segment-sums
over private edges. Everything is static-shaped and jit-compatible; edge
weights (GNC) are plain array entries, so reweighting never recompiles.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu.ops import lifted
from dpgo_tpu.types import PRECONDITIONER_SHIFT, PRIOR_KAPPA, PRIOR_TAU


# ---------------------------------------------------------------------------
# Problem data pytrees
# ---------------------------------------------------------------------------

@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "priv_i", "priv_j", "priv_T", "priv_kappa", "priv_tau", "priv_weight",
        "priv_lane",
        "shared_idx", "shared_T", "shared_kappa", "shared_tau", "shared_weight",
        "shared_outgoing", "shared_nbr_slot", "shared_mask",
        "prior_idx", "prior_pose", "prior_mask",
    ],
    meta_fields=["n", "d", "num_band", "band_offsets"],
)
@dataclasses.dataclass(frozen=True)
class LocalProblem:
    """Static-shaped arrays describing one agent's local pose graph.

    Private edges (odometry + private loop closures) have both endpoints local.
    Shared edges reference one local pose (`shared_idx`) and one neighbor pose
    held in an external buffer at `shared_nbr_slot`; `shared_outgoing` marks
    edges whose tail is local (reference: PoseGraph.cpp:412-458 branches).
    `shared_mask` zeroes edges whose neighbor is inactive/unavailable
    (reference: PoseGraph.cpp:418-430).
    """

    n: int
    d: int
    # private edges: (mp,) / (mp, dh, dh)
    priv_i: jax.Array
    priv_j: jax.Array
    priv_T: jax.Array
    priv_kappa: jax.Array
    priv_tau: jax.Array
    priv_weight: jax.Array
    # shared edges: (ms,) / (ms, dh, dh)
    shared_idx: jax.Array
    shared_T: jax.Array
    shared_kappa: jax.Array
    shared_tau: jax.Array
    shared_weight: jax.Array
    shared_outgoing: jax.Array  # bool
    shared_nbr_slot: jax.Array  # int32 into neighbor-pose buffer
    shared_mask: jax.Array  # float multiplier in {0, 1}
    # priors: (npr,) / (npr, r, dh)
    prior_idx: jax.Array
    prior_pose: jax.Array
    prior_mask: jax.Array
    # Band lanes: the first num_band private edges are "banded" — each has
    # j - i == band_offsets[priv_lane[k]] and its matvec contribution lowers
    # to a shifted dense batched matmul instead of gather/scatter (the
    # dominant hot-op rewrite: pose graphs are offset-structured —
    # odometry is offset 1, and sweep/grid loop closures concentrate on a few
    # offsets; sphere2500 is 100% covered by offsets {1, 50}). Remaining
    # edges use the gather/scatter path. See plan_bands / q_matvec.
    priv_lane: jax.Array = dataclasses.field(default=None)  # (mp,) int32
    num_band: int = 0
    band_offsets: tuple = ()

    @property
    def dh(self) -> int:
        return self.d + 1

    @property
    def num_private(self) -> int:
        return int(self.priv_i.shape[0])

    @property
    def num_shared(self) -> int:
        return int(self.shared_idx.shape[0])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "priv_i", "priv_j", "priv_T", "priv_om",
        "shared_idx", "shared_T", "shared_om", "shared_outgoing", "nbr",
        "prior_idx", "prior_pose", "prior_om",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ResidualData:
    """Edge data for the residual-form objective/gradient evaluation
    (cost_grad_residual). Mathematically identical to the matvec form
    XQ + G, but numerically cancellation-free: each edge contributes
    O(residual) directly instead of the near-cancelling O(kappa·|X|)
    partial sums of the matvec — the difference between an f32 control
    gradient flooring the reachable global gradnorm at ~2e-2 and one
    accurate to ~eps·residual (see solvers/rtr.py).

    `priv_om`/`shared_om`/`prior_om` are the weight-scaled per-column
    Omega diagonals (m, dh) = diag(w·kappa, ..., w·kappa, w·tau)
    (shared_om includes shared_mask). `nbr` holds the resolved neighbor
    pose per shared edge — round-dependent, like the linear term G.
    """

    priv_i: jax.Array
    priv_j: jax.Array
    priv_T: jax.Array
    priv_om: jax.Array
    shared_idx: jax.Array
    shared_T: jax.Array
    shared_om: jax.Array
    shared_outgoing: jax.Array
    nbr: jax.Array
    prior_idx: jax.Array
    prior_pose: jax.Array
    prior_om: jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["diag", "off_i", "off_j", "off_E", "G", "precond_inv",
                 "band_E", "btf", "res"],
    meta_fields=["n", "d", "band_offsets"],
)
@dataclasses.dataclass(frozen=True)
class QuadraticData:
    """Assembled data matrices of f(X) = 0.5 <X Q, X> + <X, G>.

    diag        : (n, dh, dh) diagonal blocks of Q
    off_i/off_j : (mp,) endpoints of private edges
    off_E       : (mp, dh, dh) with Q_ij = -E_k, Q_ji = -E_k^T
    G           : (n, r, dh) linear term
    precond_inv : (n, dh, dh) explicit inverses of the block-Jacobi
                  preconditioner blocks (Q_ii + 0.1 I); semantics follow
                  PoseGraph.cpp:598-613 with the Cholmod LDL^T of the full
                  matrix relaxed to its block diagonal. The inverse is
                  materialized once per build so the per-tCG-iteration
                  preconditioner application is a single batched matmul
                  instead of triangular solves.
    btf         : optional cyclic-reduction factorization of the
                  block-tridiagonal part of (Q + 0.1 I) — odometry-band
                  coupling + all diagonal blocks (ops/block_tridiag.py).
                  Much closer to the reference's full Cholmod LDL^T than
                  block-Jacobi; when present, apply_precond uses it.
    res         : optional ResidualData enabling the cancellation-free
                  residual-form objective/gradient (cost_grad_residual),
                  used for trust-region control in reduced precision.
    """

    n: int
    d: int
    diag: jax.Array
    off_i: jax.Array
    off_j: jax.Array
    off_E: jax.Array
    G: jax.Array
    precond_inv: jax.Array
    # (L, n, dh, dh) dense band-lane blocks — lane l holds the (merged) E
    # blocks of edges (i, i + band_offsets[l]) at row i, zeros elsewhere —
    # or None when the problem carries no band plan
    band_E: Optional[jax.Array] = None
    btf: Optional[object] = None
    res: Optional[ResidualData] = None
    band_offsets: tuple = ()


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def _omega(kappa, tau, weight, d: int):
    """Per-edge weight diagonal diag(w k, ..., w k, w t): (m, dh)."""
    wk = (weight * kappa)[:, None] * jnp.ones((1, d), kappa.dtype)
    wt = (weight * tau)[:, None]
    return jnp.concatenate([wk, wt], axis=1)


def _diag_embed(v):
    """(m, dh) -> (m, dh, dh) diagonal blocks."""
    return v[..., None] * jnp.eye(v.shape[-1], dtype=v.dtype)


def build_quadratic_data(
    problem: LocalProblem,
    nbr_poses: jax.Array,
    r: int,
    precond_shift: float = PRECONDITIONER_SHIFT,
    precond: str = "jacobi",
) -> QuadraticData:
    """Assemble Q blocks, linear term G, and preconditioner factors.

    nbr_poses: (p, r, dh) buffer of neighbor public poses indexed by
    `shared_nbr_slot` (entries for masked edges may hold garbage — they are
    multiplied by shared_mask). Matches constructQ/constructG semantics
    (reference: PoseGraph.cpp:381-580).

    Composition of build_q_data (everything that depends only on the
    measurements/weights) + build_linear_term (the neighbor-pose-dependent G).
    Iterative drivers should call the two pieces separately: Q and the
    preconditioner factors are loop-invariant across RBCD rounds (the
    reference caches them the same way via std::optional + clearDataMatrices,
    PoseGraph.h:325-331), only G needs a per-round rebuild.
    """
    qd = build_q_data(problem, r, precond_shift=precond_shift, precond=precond)
    G = build_linear_term(problem, nbr_poses, r)
    return dataclasses.replace(qd, G=G)


def build_q_data(
    problem: LocalProblem,
    r: int,
    precond_shift: float = PRECONDITIONER_SHIFT,
    precond: str = "jacobi",
) -> QuadraticData:
    """Assemble the neighbor-pose-INDEPENDENT data: Q blocks + preconditioner
    (reference: constructQ + constructPreconditioner, PoseGraph.cpp:381-491,
    598-613). The returned QuadraticData carries G = 0."""
    n, d, dh = problem.n, problem.d, problem.d + 1
    dtype = problem.priv_T.dtype

    # --- private edges ---
    om_p = _omega(problem.priv_kappa, problem.priv_tau, problem.priv_weight, d)
    E = problem.priv_T * om_p[:, None, :]  # T @ diag(om): column scaling
    W = jnp.einsum("mab,mcb->mac", E, problem.priv_T)  # E @ T^T

    diag = jnp.zeros((n, dh, dh), dtype)
    diag = diag.at[problem.priv_i].add(W)
    diag = diag.at[problem.priv_j].add(_diag_embed(om_p))

    # band lanes: dense (L, n, dh, dh) blocks (shifted-matmul matvec path);
    # remaining edges go via gather/scatter indices
    nb = problem.num_band
    offs = tuple(problem.band_offsets)
    if nb > 0 and n > 1 and offs:
        L = len(offs)
        flat = problem.priv_lane[:nb] * n + problem.priv_i[:nb]
        band_E = (
            jnp.zeros((L * n, dh, dh), dtype)
            .at[flat].add(E[:nb])
            .reshape(L, n, dh, dh)
        )
        off_i, off_j, off_E = (
            problem.priv_i[nb:], problem.priv_j[nb:], E[nb:],
        )
    else:
        band_E = None
        offs = ()
        off_i, off_j, off_E = problem.priv_i, problem.priv_j, E

    # --- shared edges (diagonal contributions) ---
    om_s = _omega(problem.shared_kappa, problem.shared_tau, problem.shared_weight, d)
    om_s = om_s * problem.shared_mask[:, None]
    Es = problem.shared_T * om_s[:, None, :]
    Ws = jnp.einsum("mab,mcb->mac", Es, problem.shared_T)
    out_f = problem.shared_outgoing[:, None, None].astype(dtype)
    diag = diag.at[problem.shared_idx].add(out_f * Ws + (1.0 - out_f) * _diag_embed(om_s))

    # --- priors (diagonal) ---
    npr = problem.prior_idx.shape[0]
    if npr > 0:
        om_prior = jnp.concatenate(
            [jnp.full((npr, d), PRIOR_KAPPA, dtype), jnp.full((npr, 1), PRIOR_TAU, dtype)],
            axis=1,
        ) * problem.prior_mask[:, None]
        diag = diag.at[problem.prior_idx].add(_diag_embed(om_prior))

    G = jnp.zeros((n, r, dh), dtype)

    # --- preconditioner of (Q + shift I) ---
    # 'jacobi': block-diagonal inverse (one batched matmul per application).
    # 'tridiag': cyclic-reduction factorization of the band-tridiagonal part
    # (odometry coupling + all diagonal blocks) — SPD by construction since
    # it is a sum of per-edge PSD terms plus the shift; far closer to the
    # reference's full Cholmod LDL^T (PoseGraph.cpp:598-613) in quality.
    # 'auto': tridiag when the odometry lane exists and the chain is short
    # enough that the O(log n)-depth cyclic-reduction solve pays for itself
    # (tridiag cut sphere2500 tCG iterations 413 -> 288, but at large block
    # sizes the deep solve can cost more than it saves; the 5,000-pose cap is
    # a threshold still to be measured on the GPU).
    if precond == "auto":
        # Prefer the exact banded factor (Cholmod-LDL^T parity; measured:
        # sphere2500 tCG 285 -> 70 iterations vs tridiag at the same
        # optimum). Needs concrete edge indices for the host-side RCM plan;
        # make_banded_plan refuses large relabeled bandwidths (e.g. 3D
        # lattices at scale), falling back to tridiag (small n) / jacobi.
        if not isinstance(problem.priv_i, jax.core.Tracer) and n > 1:
            precond = "banded"
        else:
            precond = (
                "tridiag"
                if band_E is not None and 1 in offs and 1 < n <= 5_000
                else "jacobi"
            )
    shifted = diag + precond_shift * jnp.eye(dh, dtype=dtype)
    btf = None
    if precond == "banded" and not isinstance(problem.priv_i, jax.core.Tracer):
        # Exact (Q + shift I)^{-1} via RCM relabeling + superblock cyclic
        # reduction (ops/block_tridiag.py BandedFactor) — Cholmod-LDL^T
        # parity (PoseGraph.cpp:598-613). Host-side plan: needs concrete
        # edge indices (eager / centralized path).
        from dpgo_tpu.ops import block_tridiag as _bt

        plan = _bt.make_banded_plan(
            np.asarray(problem.priv_i), np.asarray(problem.priv_j), n, dh
        )
        if plan is not None:
            btf = _bt.build_banded_factor(plan, shifted, E)
            precond_inv = jnp.zeros((0, dh, dh), dtype)
            return QuadraticData(
                n=n, d=d, diag=diag,
                off_i=off_i, off_j=off_j, off_E=off_E,
                G=G, precond_inv=precond_inv, band_E=band_E,
                btf=btf, band_offsets=offs,
            )
        # bandwidth too large: fall back under the same size policy as the
        # tracer branch of 'auto'
        precond = (
            "tridiag"
            if band_E is not None and 1 in offs and 1 < n <= 5_000
            else "jacobi"
        )
    if precond == "tridiag" and band_E is not None and 1 in offs and n > 1:
        from dpgo_tpu.ops import block_tridiag as _bt

        # the offset-1 lane is the odometry chain; the other lanes' edges
        # still strengthen the factor through their diagonal contributions
        E1 = band_E[offs.index(1), : n - 1]
        btf = _bt.factorize(shifted, E1)
        precond_inv = jnp.zeros((0, dh, dh), dtype)
    else:
        Lc = jnp.linalg.cholesky(shifted)
        eye = jnp.broadcast_to(jnp.eye(dh, dtype=dtype), shifted.shape)
        precond_inv = jax.scipy.linalg.cho_solve((Lc, True), eye)

    return QuadraticData(
        n=n, d=d, diag=diag,
        off_i=off_i, off_j=off_j, off_E=off_E,
        G=G, precond_inv=precond_inv, band_E=band_E, btf=btf,
        band_offsets=offs,
    )


def build_linear_term(
    problem: LocalProblem, nbr_poses: jax.Array, r: int
) -> jax.Array:
    """The neighbor-pose-dependent linear term G (reference: constructG,
    PoseGraph.cpp:493-580). Rebuilt every RBCD round from the freshly
    exchanged neighbor public poses; everything else in QuadraticData is
    round-invariant."""
    n, d, dh = problem.n, problem.d, problem.d + 1
    dtype = problem.priv_T.dtype
    G = jnp.zeros((n, r, dh), dtype)
    if problem.num_shared > 0:
        om_s = _omega(
            problem.shared_kappa, problem.shared_tau, problem.shared_weight, d
        ) * problem.shared_mask[:, None]
        Es = problem.shared_T * om_s[:, None, :]
        Xnbr = nbr_poses[problem.shared_nbr_slot]  # (ms, r, dh)
        # outgoing edge (tail local):  G_i += -X_j Omega T^T = -X_j E^T
        # incoming edge (head local):  G_j += -X_i T Omega   = -X_i E
        contrib_out = -jnp.einsum("mrb,mab->mra", Xnbr, Es)
        contrib_in = -jnp.einsum("mrb,mba->mra", Xnbr, Es)
        contrib = jnp.where(
            problem.shared_outgoing[:, None, None], contrib_out, contrib_in
        )
        G = G.at[problem.shared_idx].add(contrib)
    npr = problem.prior_idx.shape[0]
    if npr > 0:
        om_prior = jnp.concatenate(
            [jnp.full((npr, d), PRIOR_KAPPA, dtype),
             jnp.full((npr, 1), PRIOR_TAU, dtype)],
            axis=1,
        ) * problem.prior_mask[:, None]
        G = G.at[problem.prior_idx].add(-problem.prior_pose * om_prior[:, None, :])
    return G


def build_residual_data(
    problem: LocalProblem, nbr_poses: jax.Array
) -> ResidualData:
    """Pack the edge data needed by cost_grad_residual. Round-dependent only
    through `nbr_poses` (like build_linear_term); everything else aliases the
    LocalProblem arrays (no copies under jit)."""
    d = problem.d
    om_p = _omega(problem.priv_kappa, problem.priv_tau, problem.priv_weight, d)
    om_s = _omega(
        problem.shared_kappa, problem.shared_tau, problem.shared_weight, d
    ) * problem.shared_mask[:, None]
    npr = problem.prior_idx.shape[0]
    dtype = problem.priv_T.dtype
    if npr > 0:
        om_prior = jnp.concatenate(
            [jnp.full((npr, d), PRIOR_KAPPA, dtype),
             jnp.full((npr, 1), PRIOR_TAU, dtype)],
            axis=1,
        ) * problem.prior_mask[:, None]
    else:
        om_prior = jnp.zeros((0, d + 1), dtype)
    return ResidualData(
        priv_i=problem.priv_i, priv_j=problem.priv_j,
        priv_T=problem.priv_T, priv_om=om_p,
        shared_idx=problem.shared_idx, shared_T=problem.shared_T,
        shared_om=om_s, shared_outgoing=problem.shared_outgoing,
        nbr=nbr_poses[problem.shared_nbr_slot],
        prior_idx=problem.prior_idx, prior_pose=problem.prior_pose,
        prior_om=om_prior,
    )


def cost_grad_residual(
    rd: ResidualData, X: jax.Array, precision=None
) -> Tuple[jax.Array, jax.Array]:
    """Objective and Euclidean gradient in residual form.

    For each edge with homogeneous T = [[R, t], [0, 1]] and per-column
    weights om: Res = X_i T - X_j (r, dh), f_e = 0.5 <Res·diag(om), Res>,
    with gradient contributions  dX_i += (Res·om) Tᵀ,  dX_j -= (Res·om).
    Shared edges use the cached neighbor pose for the remote end (reference
    semantics: constructG, PoseGraph.cpp:493-580); priors use
    Res = X_k - prior_pose.

    Exactly equal (in exact arithmetic) to (cost(qd, X), euc_grad(qd, X))
    up to a CONSTANT objective offset 0.5·Σ_shared‖X_nbr‖²_om +
    0.5·Σ_priors‖P‖²_om (the complete-residual convention) — constant
    offsets cancel in every trust-region decision. Numerically the form is
    cancellation-free: every term is O(residual), so an f32 evaluation has
    ~eps·‖residual‖ absolute error where the matvec form XQ + G loses all
    significant digits near convergence (partial sums O(kappa·|X|) cancel
    to O(gradnorm)). This is what lets reduced-precision trust-region
    control certify reference-quality (f64-class) gradient norms.

    precision: einsum precision — pass jax.lax.Precision.HIGHEST when X is
    f32 (with the default precision a GPU may run f32 products in TF32).
    """
    pr_ = precision
    n = X.shape[0]
    r, dh = X.shape[1], X.shape[2]
    Xf = X.reshape(n, r * dh)
    G = jnp.zeros((n, r * dh), X.dtype)

    # private edges
    m = rd.priv_i.shape[0]
    if m > 0:
        Xi = Xf[rd.priv_i].reshape(m, r, dh)
        Xj = Xf[rd.priv_j].reshape(m, r, dh)
        Res = jnp.einsum("mra,mab->mrb", Xi, rd.priv_T, precision=pr_) - Xj
        Rw = Res * rd.priv_om[:, None, :]
        f = 0.5 * jnp.vdot(Res, Rw, precision=pr_)
        gi = jnp.einsum("mrb,mab->mra", Rw, rd.priv_T, precision=pr_)
        G = G.at[rd.priv_i].add(gi.reshape(m, r * dh))
        G = G.at[rd.priv_j].add(-Rw.reshape(m, r * dh))
    else:
        f = jnp.zeros((), X.dtype)

    # shared edges (remote end = cached neighbor pose)
    ms = rd.shared_idx.shape[0]
    if ms > 0:
        Xl = Xf[rd.shared_idx].reshape(ms, r, dh)
        out_f = rd.shared_outgoing[:, None, None]
        tail = jnp.where(out_f, Xl, rd.nbr)
        head = jnp.where(out_f, rd.nbr, Xl)
        Res = jnp.einsum("mra,mab->mrb", tail, rd.shared_T, precision=pr_) - head
        Rw = Res * rd.shared_om[:, None, :]
        f = f + 0.5 * jnp.vdot(Res, Rw, precision=pr_)
        contrib = jnp.where(
            out_f,
            jnp.einsum("mrb,mab->mra", Rw, rd.shared_T, precision=pr_),
            -Rw,
        )
        G = G.at[rd.shared_idx].add(contrib.reshape(ms, r * dh))

    # priors
    npr = rd.prior_idx.shape[0]
    if npr > 0:
        Res = Xf[rd.prior_idx].reshape(npr, r, dh) - rd.prior_pose
        Rw = Res * rd.prior_om[:, None, :]
        f = f + 0.5 * jnp.vdot(Res, Rw, precision=pr_)
        G = G.at[rd.prior_idx].add(Rw.reshape(npr, r * dh))

    return f, G.reshape(n, r, dh)


# ---------------------------------------------------------------------------
# Operator evaluations (reference: QuadraticProblem.cpp:29-83)
# ---------------------------------------------------------------------------

def q_matvec(qd: QuadraticData, V: jax.Array, precision=None) -> jax.Array:
    """(V Q) in block form: out_j = sum_i V_i Q_ij. V: (n, r, dh).

    Gathers/scatters run on flattened (n, r*dh) rows: one contiguous row per
    edge instead of a tiny (r, dh) block.

    precision: matmul precision for the einsums. None (default) lets a GPU
    run f32 products in TF32 — tolerable inside the trust-region-bounded
    tCG; pass jax.lax.Precision.HIGHEST for true-f32 results (needed when an
    f32 matvec supplies the GRADIENT in mixed-precision control, see
    solvers/rtr.py). f64 inputs are unaffected."""
    pr_ = precision
    out = jnp.einsum("nrb,nbc->nrc", V, qd.diag, precision=pr_)
    n, r, dh = V.shape
    if qd.band_E is not None:
        # Band lanes, fused across ALL offsets: lane l holds E blocks of
        # edges (i, i + delta_l) at row i (zeros elsewhere). The op count is
        # independent of the lane count — two batched einsums plus two
        # structured gathers — because at small n the round is dispatch-
        # bound, not bandwidth-bound (a per-lane Python loop emits ~5 ops
        # per lane inside the tCG while_loop).
        offs = jnp.asarray(qd.band_offsets, jnp.int32)  # (L,)
        L = len(qd.band_offsets)
        iota = jnp.arange(n, dtype=jnp.int32)
        # tail-side: out[i] -= sum_l V[i + delta_l] @ E[l, i]^T.
        # Offsets may be negative (backward edges j < i stay on their lane
        # un-flipped — the lifted translation cost is NOT invariant under
        # edge reversal, so flipping would change the objective). Rows whose
        # i + delta_l falls outside [0, n) have zero E blocks, so the clipped
        # gather's garbage is annihilated.
        up = jnp.clip(iota[None, :] + offs[:, None], 0, n - 1)  # (L, n)
        Vs = V[up.reshape(-1)].reshape(L, n, r, dh)
        out = out - jnp.einsum("lnrb,lncb->nrc", Vs, qd.band_E, precision=pr_)
        # head-side: out[j] -= sum_l (V @ E)[l, j - delta_l]; j - delta_l
        # outside [0, n) gathers the appended zero row.
        C = jnp.einsum("nrb,lnbc->lnrc", V, qd.band_E, precision=pr_).reshape(L * n, r, dh)
        C = jnp.concatenate([C, jnp.zeros((1, r, dh), C.dtype)])
        down = iota[None, :] - offs[:, None]  # (L, n)
        flat = jnp.where(
            (down >= 0) & (down < n),
            jnp.arange(L, dtype=jnp.int32)[:, None] * n + down,
            L * n,
        )
        out = out - jnp.sum(C[flat.reshape(-1)].reshape(L, n, r, dh), axis=0)
    m = qd.off_E.shape[0]
    if m == 0:
        return out
    Vf = V.reshape(n, r * dh)
    Vi = Vf[qd.off_i].reshape(m, r, dh)
    Vj = Vf[qd.off_j].reshape(m, r, dh)
    ci = jnp.einsum("mrb,mbc->mrc", Vi, qd.off_E, precision=pr_).reshape(m, r * dh)
    cj = jnp.einsum("mrb,mcb->mrc", Vj, qd.off_E, precision=pr_).reshape(m, r * dh)
    outf = out.reshape(n, r * dh)
    outf = outf.at[qd.off_j].add(-ci)
    outf = outf.at[qd.off_i].add(-cj)
    return outf.reshape(n, r, dh)


def cost(qd: QuadraticData, X: jax.Array) -> jax.Array:
    """f(X) = 0.5 <X Q, X> + <X, G> (reference: QuadraticProblem.cpp:29-41)."""
    return 0.5 * jnp.vdot(q_matvec(qd, X), X) + jnp.vdot(X, qd.G)


def euc_grad(qd: QuadraticData, X: jax.Array) -> jax.Array:
    """Euclidean gradient X Q + G (reference: QuadraticProblem.cpp:43-47)."""
    return q_matvec(qd, X) + qd.G


def rie_grad(qd: QuadraticData, X: jax.Array) -> jax.Array:
    """Riemannian gradient: tangent projection of the Euclidean gradient
    (reference: QuadraticProblem.cpp:71-79)."""
    return lifted.proj_tangent(X, euc_grad(qd, X))


def rie_grad_norm(qd: QuadraticData, X: jax.Array) -> jax.Array:
    return lifted.norm(rie_grad(qd, X))


def rie_hess_vec(qd: QuadraticData, X: jax.Array, S: jax.Array, V: jax.Array,
                 precision=None) -> jax.Array:
    """Riemannian Hessian action for the embedded product manifold.

    For a Stiefel block with Euclidean gradient g_i and symmetric
    S_i = sym(Y_i^T g_i):  Hess[eta]_i = P_Y( (eta Q)_i - eta_i S_i ).
    The translation factor is Euclidean: Hess = (eta Q)_i.
    S is precomputed once per outer RTR iteration via `hess_correction`.

    (ROPTLIB applies the same Euclidean-to-Riemannian Hessian conversion
    inside RTRNewton; the reference supplies EucHessianEta = V Q at
    QuadraticProblem.cpp:49-54.)
    """
    HV = q_matvec(qd, V, precision=precision)
    corr = jnp.einsum("...ra,...ab->...rb", lifted.rotations(V), S,
                      precision=precision)
    Hrot = lifted.stiefel_proj_tangent(
        lifted.rotations(X), lifted.rotations(HV) - corr
    )
    return lifted.assemble(Hrot, lifted.translations(HV))


def hess_correction(X: jax.Array, eg: jax.Array) -> jax.Array:
    """S_i = sym(Y_i^T g_i^rot): (n, d, d), the Weingarten correction term.
    HIGHEST precision: per-pose tiny matmuls feeding the Hessian model."""
    YtG = jnp.einsum(
        "nra,nrb->nab", lifted.rotations(X), lifted.rotations(eg),
        precision=jax.lax.Precision.HIGHEST,
    )
    return 0.5 * (YtG + jnp.swapaxes(YtG, -1, -2))


def precond_solve(qd: QuadraticData, V: jax.Array,
                  precision=None) -> jax.Array:
    """Raw preconditioner solve (no tangent projection): out with
    out P = V for the SPD preconditioner P ~ Q + shift*I. With a
    block-tridiagonal factorization attached, the row-vector system becomes
    P out^T = V^T per pose block (P symmetric); otherwise block-Jacobi: one
    batched matmul against the materialized symmetric inverse. Also used as
    the eigen-preconditioner of the optimality certificate
    (solvers/certify.py)."""
    if qd.btf is not None:
        from dpgo_tpu.ops import block_tridiag as _bt

        if isinstance(qd.btf, _bt.BandedFactor):
            return _bt.solve_banded(qd.btf, V)
        return jnp.swapaxes(
            _bt.solve(qd.btf, jnp.swapaxes(V, -1, -2)), -1, -2
        )
    return jnp.einsum("nrb,nbc->nrc", V, qd.precond_inv,
                      precision=precision)


def apply_precond(qd: QuadraticData, X: jax.Array, V: jax.Array,
                  precision=None) -> jax.Array:
    """Preconditioner solve + tangent projection at X (reference:
    QuadraticProblem.cpp:56-69)."""
    return lifted.proj_tangent(X, precond_solve(qd, V, precision=precision))


# ---------------------------------------------------------------------------
# Host-side constructors
# ---------------------------------------------------------------------------

def make_local_problem(
    n: int,
    d: int,
    priv_i,
    priv_j,
    priv_T,
    priv_kappa,
    priv_tau,
    priv_weight,
    shared_idx=None,
    shared_T=None,
    shared_kappa=None,
    shared_tau=None,
    shared_weight=None,
    shared_outgoing=None,
    shared_nbr_slot=None,
    shared_mask=None,
    prior_idx=None,
    prior_pose=None,
    prior_mask=None,
    r: Optional[int] = None,
    dtype=jnp.float64,
) -> LocalProblem:
    """Build a LocalProblem pytree from host arrays, filling empty defaults."""
    dh = d + 1
    r = d if r is None else r

    def arr(x, shape, dt=dtype):
        if x is None:
            return jnp.zeros(shape, dt)
        return jnp.asarray(x, dt)

    ms = 0 if shared_idx is None else len(shared_idx)
    npr = 0 if prior_idx is None else len(prior_idx)
    return LocalProblem(
        n=n,
        d=d,
        priv_lane=jnp.zeros((len(priv_i),), jnp.int32),
        priv_i=jnp.asarray(priv_i, jnp.int32),
        priv_j=jnp.asarray(priv_j, jnp.int32),
        priv_T=jnp.asarray(priv_T, dtype),
        priv_kappa=jnp.asarray(priv_kappa, dtype),
        priv_tau=jnp.asarray(priv_tau, dtype),
        priv_weight=jnp.asarray(priv_weight, dtype),
        shared_idx=arr(shared_idx, (ms,), jnp.int32),
        shared_T=arr(shared_T, (ms, dh, dh)),
        shared_kappa=arr(shared_kappa, (ms,)),
        shared_tau=arr(shared_tau, (ms,)),
        shared_weight=arr(shared_weight, (ms,)),
        shared_outgoing=arr(shared_outgoing, (ms,), bool),
        shared_nbr_slot=arr(shared_nbr_slot, (ms,), jnp.int32),
        shared_mask=arr(shared_mask, (ms,)),
        prior_idx=arr(prior_idx, (npr,), jnp.int32),
        prior_pose=arr(prior_pose, (npr, r, dh)),
        prior_mask=arr(prior_mask, (npr,)),
    )


def choose_band_offsets(
    i_np: np.ndarray,
    j_np: np.ndarray,
    n: int,
    max_lanes: int = 16,
    min_count: Optional[int] = None,
    rows: Optional[int] = None,
) -> tuple:
    """Host-side: pick the edge offsets worth a dense band lane, by COST
    MODEL. A lane's matvec contribution is a dense shifted einsum over every
    one of `rows` rows (`rows` = n centrally, num_agents*n_max in the vmapped
    SPMD stack) whether or not a row carries an edge; an edge left on the
    gather/scatter path was measured at ~2x a lane ROW (at 100k poses, on
    the hardware the model was first tuned on; not yet re-measured on the
    GPU). Strict breakeven is therefore
    count ~ rows/2; the implemented threshold is deliberately rows//3 —
    slightly below breakeven — because a lane also removes its edges from the
    gather/scatter index arrays (smaller residual gather launches, better
    padding) and the measured c_edge/c_row ratio varies ~1.5-2.5x with block
    size, so rows//3 keeps marginally-paying lanes that rows//2 would drop.
    The r3 floor of n//32 admitted 16 lanes at 0.68 total coverage on
    city2d-100k, a ~3x matvec-traffic waste. Exception: when the
    qualifying offsets cover EVERY edge within the lane budget at moderate
    total cost, keep them all — full coverage deletes the gather/scatter
    machinery from the program entirely (the sphere2500 {1,50} / torus3D
    {1,100,4900} / raster-grid {1,s,s^2} wins). Returns sorted offsets."""
    if n < 2 or len(i_np) == 0:
        return ()
    if rows is None:
        rows = n
    delta = j_np - i_np
    # Negative offsets (backward edges j < i) qualify too: they get their own
    # lane rather than being flipped — the lifted translation cost is not
    # invariant under edge reversal (see q_matvec).
    valid = (delta != 0) & (np.abs(delta) < n)
    vals, cnts = np.unique(delta[valid], return_counts=True)
    if min_count is None:
        # full-coverage exception: lane rows <= gather-path cost in row
        # equivalents (c_edge ~ 2*c_row) + the fixed gather/scatter op
        # overhead full coverage deletes (~20 us ~ 1300 row-equivalents)
        m_total = int(valid.sum())
        if (
            len(vals) > 0
            and len(vals) <= max_lanes
            and rows * len(vals) <= 2 * m_total + 1300
        ):
            min_count = 1
        else:
            min_count = max(16, rows // 3)
    keep = vals[cnts >= min_count]
    kcnt = cnts[cnts >= min_count]
    if len(keep) > max_lanes:
        top = np.argsort(-kcnt)[:max_lanes]
        keep, kcnt = keep[top], kcnt[top]
    # always include the odometry offset if present at all (it also feeds
    # the block-tridiagonal preconditioner)
    if 1 in vals and 1 not in keep:
        if len(keep) >= max_lanes:
            # evict the LOWEST-count lane; keep is only count-ordered when
            # the > max_lanes truncation ran, so re-sort explicitly (at
            # len == max_lanes exactly it is in ascending-OFFSET order and
            # slicing would evict the largest offset instead)
            order = np.argsort(-kcnt)
            keep = np.append(keep[order][: max_lanes - 1], 1)
        else:
            keep = np.append(keep, 1)
    return tuple(int(v) for v in np.sort(keep))


def plan_bands(
    problem: LocalProblem,
    max_lanes: int = 16,
    min_count: Optional[int] = None,
    offsets: Optional[tuple] = None,
) -> LocalProblem:
    """Host-side: reorder private edges so banded edges (j - i in a small set
    of common offsets) come first, assign each a lane, and record the offset
    set. Their matvec contributions then lower to shifted dense batched
    matmuls (no gather/scatter) — pose graphs are offset-structured
    (odometry = offset 1; sweep/grid loop closures concentrate on a few
    offsets: sphere2500 is fully covered by {1, 50}, torus3D by {1, 100,
    4900}). Pass `offsets` to force a specific lane set."""
    i_np = np.asarray(problem.priv_i)
    j_np = np.asarray(problem.priv_j)
    if offsets is None:
        offsets = choose_band_offsets(
            i_np, j_np, problem.n, max_lanes=max_lanes, min_count=min_count
        )
    offsets = tuple(int(d) for d in offsets)
    if not offsets:
        return dataclasses.replace(
            problem,
            priv_lane=jnp.zeros(i_np.shape, jnp.int32),
            num_band=0, band_offsets=(),
        )
    lane_of = {d: k for k, d in enumerate(offsets)}
    delta = j_np - i_np
    lane = np.array([lane_of.get(int(x), -1) for x in delta], np.int32)
    banded = lane >= 0
    order = np.concatenate([np.flatnonzero(banded), np.flatnonzero(~banded)])
    nb = int(banded.sum())
    o = jnp.asarray(order)
    return dataclasses.replace(
        problem,
        priv_i=problem.priv_i[o],
        priv_j=problem.priv_j[o],
        priv_T=problem.priv_T[o],
        priv_kappa=problem.priv_kappa[o],
        priv_tau=problem.priv_tau[o],
        priv_weight=problem.priv_weight[o],
        priv_lane=jnp.asarray(np.maximum(lane[order], 0)),
        num_band=nb,
        band_offsets=offsets,
    )


def with_band_ordering(problem: LocalProblem) -> LocalProblem:
    """Back-compat alias: single odometry band (offset 1 only)."""
    return plan_bands(problem, offsets=(1,))


def from_private_measurements(
    edges, n: int, d: int, dtype=jnp.float64, band: bool = True
) -> LocalProblem:
    """LocalProblem with only private edges, from an EdgeArrays (all endpoints
    must belong to the same robot). band=True plans dense band lanes for the
    common edge offsets (odometry + structured loop closures) so their matvec
    contributions avoid gather/scatter."""
    from dpgo_tpu.measurements import homogeneous

    T = homogeneous(edges.R, edges.t).astype(np.float64)
    problem = make_local_problem(
        n=n, d=d,
        priv_i=edges.p1, priv_j=edges.p2, priv_T=T,
        priv_kappa=edges.kappa, priv_tau=edges.tau, priv_weight=edges.weight,
        dtype=dtype,
    )
    return plan_bands(problem) if band else problem
