"""Block-tridiagonal SPD solver via cyclic reduction — the batched
replacement for the reference's Cholmod LDL^T preconditioner
(reference: src/PoseGraph.cpp:598-613, applied per tCG iteration at
src/QuadraticProblem.cpp:56-69).

The reference factors the FULL sparse matrix (Q + 0.1 I). An exact sparse
LDL^T is a sequential, pointer-chasing algorithm that batches poorly.
Instead we factor the *block-tridiagonal part* of (Q + 0.1 I): the odometry
chain's full (d+1)x(d+1) block coupling plus every edge's diagonal
contribution. This matrix is provably SPD (it is a sum of per-edge PSD terms
plus the shift — loop-closure edges contribute only their PSD diagonal
blocks), and for chain-dominated pose graphs it captures most of Q's
conditioning, cutting tCG iterations far below block-Jacobi.

Cyclic reduction maps to the hardware: log2(n) levels, each a batch of small
(dh x dh) matmuls/inverses — no sequential O(n) scans on the critical path.
The factorization (per-level eliminated-block inverses and coupling products)
is computed once per data-matrix build; each preconditioner application is a
down-sweep + up-sweep of ~2 log2(n) batched matmuls.

System convention: M x = b with
    M[i, i]   = D[i]            (n, b, b)  SPD diagonal blocks
    M[i, i+1] = -E[i]           (n-1, b, b)
    M[i+1, i] = -E[i]^T
matching QuadraticData's (diag + shift, band_E) layout.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class CRLevel(NamedTuple):
    """One cyclic-reduction level's factors (all shapes static).

    m: number of blocks entering this level. Odd positions are eliminated,
    ceil(m/2) even positions are kept for the next level.
    """

    # eliminated (odd) positions: k = 0..n_odd-1 <-> original position 2k+1
    odd_inv: jax.Array  # (n_odd, b, b)  D_odd^{-1}
    odd_L: jax.Array  # (n_odd, b, b)  M[odd, odd-1]
    odd_U: jax.Array  # (n_odd, b, b)  M[odd, odd+1] (zero block at boundary)
    # kept (even) positions: k = 0..n_even-1 <-> original position 2k
    LD: jax.Array  # (n_even, b, b)  M[even, even-1] @ D_{even-1}^{-1}
    UD: jax.Array  # (n_even, b, b)  M[even, even+1] @ D_{even+1}^{-1}


class CRFactor(NamedTuple):
    levels: Tuple[CRLevel, ...]
    root_inv: jax.Array  # (1, b, b) inverse of the final 1-block system


def _spd_inv(D: jax.Array) -> jax.Array:
    """Batched SPD inverse via Cholesky (small blocks, numerically stable)."""
    b = D.shape[-1]
    L = jnp.linalg.cholesky(D)
    eye = jnp.broadcast_to(jnp.eye(b, dtype=D.dtype), D.shape)
    return jax.scipy.linalg.cho_solve((L, True), eye)


def _pad_blocks(A: jax.Array, front: int, back: int) -> jax.Array:
    return jnp.pad(A, ((front, back), (0, 0), (0, 0)))


def factorize(D: jax.Array, E: jax.Array) -> CRFactor:
    """Cyclic-reduction factorization of the SPD block-tridiagonal matrix.

    D: (n, b, b) diagonal blocks; E: (n-1, b, b) with M[i, i+1] = -E[i].
    Returns a CRFactor whose solve() applies M^{-1}. n may be any size >= 1;
    there are ceil(log2(n)) levels. Fully batched; safe under vmap/jit.
    """
    n = D.shape[0]
    # upper coupling per position: U[i] = M[i, i+1] = -E[i], zero at i = n-1
    U = _pad_blocks(-E, 0, 1) if n > 1 else jnp.zeros_like(D)
    # lower coupling per position: L[i] = M[i, i-1] = -E[i-1]^T, zero at i = 0
    L = _pad_blocks(-jnp.swapaxes(E, -1, -2), 1, 0) if n > 1 else jnp.zeros_like(D)

    levels: List[CRLevel] = []
    while n > 1:
        n_odd = n // 2
        n_even = n - n_odd
        D_odd = D[1::2]
        odd_inv = _spd_inv(D_odd)
        odd_L = L[1::2]
        odd_U = U[1::2]

        # neighbors of kept (even) positions; zero blocks where out of range
        inv_pad = _pad_blocks(odd_inv, 1, 1)  # index k+1 <-> odd position 2k+1
        # left odd neighbor of even 2k is 2k-1 (odd index k-1 -> pad slot k)
        invL = inv_pad[:n_even]
        # right odd neighbor of even 2k is 2k+1 (odd index k -> pad slot k+1)
        invR = inv_pad[1 : n_even + 1]

        L_even = L[0::2]
        U_even = U[0::2]
        LD = jnp.einsum("kab,kbc->kac", L_even, invL)
        UD = jnp.einsum("kab,kbc->kac", U_even, invR)

        levels.append(CRLevel(odd_inv=odd_inv, odd_L=odd_L, odd_U=odd_U,
                              LD=LD, UD=UD))

        # reduced system on even positions: even 2k's left odd neighbor is
        # odd index k-1, its right odd neighbor is odd index k
        oL = _pad_blocks(odd_L, 1, 1)[:n_even]  # L of left odd neighbor
        oU = _pad_blocks(odd_U, 0, 1)[:n_even]  # U of right odd neighbor
        oU_left = _pad_blocks(odd_U, 1, 1)[:n_even]  # U of left odd neighbor
        oL_right = _pad_blocks(odd_L, 0, 1)[:n_even]  # L of right odd neighbor

        D = D[0::2] - jnp.einsum("kab,kbc->kac", LD, oU_left) \
            - jnp.einsum("kab,kbc->kac", UD, oL_right)
        L_new = -jnp.einsum("kab,kbc->kac", LD, oL)
        U_new = -jnp.einsum("kab,kbc->kac", UD, oU)
        # the reduced system's L[0] / U[last] must be zero blocks: guaranteed
        # because LD[0] multiplies a zero L_even[0] and the last UD a zero U.
        L, U, n = L_new, U_new, n_even

    return CRFactor(levels=tuple(levels), root_inv=_spd_inv(D))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cr", "perm", "invp"],
    meta_fields=["s", "nb", "n"],
)
@dataclasses.dataclass(frozen=True)
class BandedFactor:
    """Exact banded factorization of (Q + shift I) under an RCM relabeling.

    The reference preconditions tCG with a Cholmod LDL^T of the FULL sparse
    matrix (PoseGraph.cpp:598-613). Sparse LDL^T is pointer-chasing and
    batches poorly — but pose ids are arbitrary labels, and under a reverse
    Cuthill-McKee relabeling real pose graphs collapse to small bandwidth
    (ais2klinik: 15104 -> 34; city10000: 9480 -> 182; CSAIL: 1025 -> 19).
    Grouping s >= bandwidth consecutive relabeled poses into superblocks
    makes the matrix block-TRIDIAGONAL in (s*dh x s*dh) superblocks — every
    edge lands in the same or adjacent superblock — so the existing cyclic
    reduction factors it EXACTLY: O(log(n/s)) depth in dense batched
    blocks, with Cholmod-LDL^T parity.

    perm: (nb*s,) new -> old pose id (padded tail entries repeat pose 0 and
    are masked by pad handling); invp: (n,) old -> new.
    """

    s: int
    nb: int
    n: int
    perm: jax.Array  # (nb*s,) int32, clipped gather map new -> old
    invp: jax.Array  # (n,) int32 old -> new
    cr: CRFactor


class BandedPlan(NamedTuple):
    """Host-side static scatter plan for build_banded_factor (all numpy)."""

    s: int
    nb: int
    n: int
    dh: int
    bandwidth: int
    perm: np.ndarray  # (nb*s,) new -> old (clipped)
    invp: np.ndarray  # (n,) old -> new
    diag_k: np.ndarray  # (n,) superblock of each (old) pose
    diag_r: np.ndarray  # (n,) row offset (poses) within the superblock
    pad_diag: np.ndarray  # (nb, s*dh) 1.0 on padding rows' diagonal
    # per-edge placements; masked entries carry weight 0 and clipped indices
    ek_fwd: np.ndarray  # (m,) D-superblock of the (a, b) entry
    er_fwd: np.ndarray  # (m,) row (pose) offset of a
    ec_fwd: np.ndarray  # (m,) col (pose) offset of b
    em_fwd: np.ndarray  # (m,) 1.0 iff same-superblock
    ek_cpl: np.ndarray  # (m,) C-superblock index of the coupling entry
    er_cpl: np.ndarray  # (m,) row (pose) offset within the coupling block
    ec_cpl: np.ndarray  # (m,) col (pose) offset
    et_cpl: np.ndarray  # (m,) 1.0 iff the coupling entry holds -E^T (else -E)
    em_cpl: np.ndarray  # (m,) 1.0 iff adjacent-superblock
    dropped: int  # edges spanning >= 2 superblocks (0 when s >= bandwidth)


def make_banded_plan(
    i, j, n: int, dh: int, s: Optional[int] = None, max_block: int = 1024
) -> Optional[BandedPlan]:
    """RCM-relabel the pose graph and plan the superblock scatter (host-side,
    static). Returns None when the relabeled bandwidth is too large for an
    exact factor of acceptable block size (s*dh > max_block): factor memory
    is ~5*n*s*dh^2 floats, linear in s."""
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee as _rcm

    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    m = len(i)
    A = _sp.coo_matrix((np.ones(m), (i, j)), shape=(n, n))
    A = (A + A.T).tocsr()
    perm_no = np.asarray(_rcm(A, symmetric_mode=True), np.int64)  # new -> old
    invp = np.empty(n, np.int64)
    invp[perm_no] = np.arange(n)
    a = invp[i]
    b = invp[j]
    bw = int(np.abs(a - b).max()) if m else 1
    if s is None:
        s = max(8, ((bw + 7) // 8) * 8)
    if s * dh > max_block:
        return None
    nb = (n + s - 1) // s
    ka, ra = a // s, a % s
    kb, rb = b // s, b % s
    same = ka == kb
    fwd = kb == ka + 1  # (a, b) sits in M[ka, ka+1]
    bwd = ka == kb + 1  # (b, a) sits in M[kb, kb+1], transposed block
    adj = fwd | bwd
    dropped = int(m - same.sum() - adj.sum())
    pad_diag = np.zeros((nb, s * dh))
    flat_pad = np.arange(nb * s) >= n
    pad_diag.reshape(nb, s, dh)[flat_pad.reshape(nb, s)] = 1.0
    perm_pad = np.concatenate([perm_no, np.zeros(nb * s - n, np.int64)])
    zero = np.zeros(m, np.int64)
    return BandedPlan(
        s=s, nb=nb, n=n, dh=dh, bandwidth=bw,
        perm=perm_pad, invp=invp,
        diag_k=invp // s, diag_r=invp % s, pad_diag=pad_diag,
        ek_fwd=np.where(same, ka, zero),
        er_fwd=np.where(same, ra, zero),
        ec_fwd=np.where(same, rb, zero),
        em_fwd=same.astype(np.float64),
        ek_cpl=np.where(fwd, ka, np.where(bwd, kb, zero)),
        er_cpl=np.where(fwd, ra, np.where(bwd, rb, zero)),
        ec_cpl=np.where(fwd, rb, np.where(bwd, ra, zero)),
        et_cpl=bwd.astype(np.float64),
        em_cpl=adj.astype(np.float64),
        dropped=dropped,
    )


def build_banded_factor(
    plan: BandedPlan, shifted_diag: jax.Array, E_edges: jax.Array
) -> BandedFactor:
    """Assemble the superblock-tridiagonal matrix and factor it (jit-able;
    scatter indices are static, only the block VALUES are runtime — GNC
    reweights never recompile).

    shifted_diag: (n, dh, dh) = Q's diagonal blocks + shift I (old labels).
    E_edges: (m, dh, dh) per-edge E_k = T_k Omega_k, so Q[i, j] = -E_k and
    Q[j, i] = -E_k^T (weights folded in — zero-weight rows vanish).
    """
    s, nb, n, dh = plan.s, plan.nb, plan.n, plan.dh
    dt = shifted_diag.dtype
    sdh = s * dh
    ar = jnp.arange(dh, dtype=jnp.int32)

    def blk_idx(k, r, c):
        """(v,) superblock ids + (v,) pose row/col offsets -> broadcastable
        (v, dh, dh) element index triple."""
        K = jnp.asarray(k, jnp.int32)[:, None, None]
        R = (jnp.asarray(r, jnp.int32)[:, None] * dh + ar)[:, :, None]
        C = (jnp.asarray(c, jnp.int32)[:, None] * dh + ar)[:, None, :]
        return K, R, C

    D = jnp.zeros((nb, sdh, sdh), dt)
    # diagonal blocks of every real pose, then 1.0 on padding rows
    K, R, C = blk_idx(plan.diag_k, plan.diag_r, plan.diag_r)
    D = D.at[K, R, C].add(shifted_diag)
    D = D + jnp.asarray(plan.pad_diag, dt)[:, :, None] * jnp.eye(sdh, dtype=dt)

    ET = jnp.swapaxes(E_edges, -1, -2)
    # same-superblock entries: (a, b) = -E and its mirror (b, a) = -E^T
    mf = jnp.asarray(plan.em_fwd, dt)[:, None, None]
    K, R, C = blk_idx(plan.ek_fwd, plan.er_fwd, plan.ec_fwd)
    D = D.at[K, R, C].add(-E_edges * mf)
    # mirror entry (b, a) = -E^T: swapping the row/col index arrays already
    # transposes the placement, so the VALUE stays -E
    D = D.at[K, C, R].add(-E_edges * mf)

    # adjacent-superblock coupling C[k] = M[k, k+1]; the mirror block
    # M[k+1, k] = C[k]^T is implied by factorize's symmetric convention
    mc = jnp.asarray(plan.em_cpl, dt)[:, None, None]
    tc = jnp.asarray(plan.et_cpl, dt)[:, None, None]
    val = jnp.where(tc > 0, -ET, -E_edges) * mc
    Cb = jnp.zeros((max(nb - 1, 1), sdh, sdh), dt)
    K, R, C = blk_idx(plan.ek_cpl, plan.er_cpl, plan.ec_cpl)
    Cb = Cb.at[K, R, C].add(val)

    # factorize expects M[k, k+1] = -E_sb[k]
    cr = factorize(D, -Cb[: nb - 1])
    return BandedFactor(
        s=s, nb=nb, n=n,
        perm=jnp.asarray(plan.perm, jnp.int32),
        invp=jnp.asarray(plan.invp, jnp.int32),
        cr=cr,
    )


def solve_banded(bf: BandedFactor, V: jax.Array) -> jax.Array:
    """Apply the banded factor to row-vector blocks V: (n, r, dh) -> (n, r, dh).

    Solves out M = V per pose block (M scalar-symmetric): permute to RCM
    order, stack each superblock's s pose blocks into one (s*dh, r) rhs,
    run the cyclic-reduction solve, and permute back."""
    n, r, dh = V.shape
    # the perm tail (padding rows) is clipped to pose 0: those rhs rows hit
    # decoupled identity rows of M and their solutions are dropped by invp
    Vp = V[bf.perm]
    rhs = jnp.swapaxes(
        Vp.reshape(bf.nb, bf.s, r, dh), 2, 3
    ).reshape(bf.nb, bf.s * dh, r)
    x = solve(bf.cr, rhs)
    x = jnp.swapaxes(
        x.reshape(bf.nb, bf.s, dh, r), 2, 3
    ).reshape(bf.nb * bf.s, r, dh)
    return x[bf.invp]


class StackedBandedPlan(NamedTuple):
    """Per-agent banded plans with a COMMON superblock size (uniform shapes,
    so the factor assembly and solve vmap over the agent axis). Array fields
    carry a leading (A,) axis; the statics (s, nb, n, dh) are shared. Used by
    the SPMD path to give every agent the exact banded preconditioner
    (reference parity: each PGOAgent owns a full Cholmod LDL^T of ITS local
    Q, PoseGraph.cpp:598-613)."""

    s: int
    nb: int
    n: int
    dh: int
    pad_diag: np.ndarray  # (nb, s*dh) — identical for every agent (same n)
    perm: np.ndarray  # (A, nb*s)
    invp: np.ndarray  # (A, n)
    diag_k: np.ndarray  # (A, n)
    diag_r: np.ndarray  # (A, n)
    ek_fwd: np.ndarray  # (A, m)
    er_fwd: np.ndarray
    ec_fwd: np.ndarray
    em_fwd: np.ndarray
    ek_cpl: np.ndarray
    er_cpl: np.ndarray
    ec_cpl: np.ndarray
    et_cpl: np.ndarray
    em_cpl: np.ndarray


_STACKED_ARRAY_FIELDS = (
    "perm", "invp", "diag_k", "diag_r", "ek_fwd", "er_fwd", "ec_fwd",
    "em_fwd", "ek_cpl", "er_cpl", "ec_cpl", "et_cpl", "em_cpl",
)


def make_banded_plans_stacked(
    i_stk, j_stk, n: int, dh: int, max_block: int = 1024
) -> Optional[StackedBandedPlan]:
    """Host-side: one banded plan per agent at a common superblock size
    s = max over agents' RCM bandwidths (so no agent drops coupling entries
    and all shapes are vmap-uniform). Returns None when the common s would
    exceed max_block/dh — callers fall back to tridiag/jacobi. Padding edges
    (i = j = 0, weight 0) only add a harmless self-loop to the RCM graph;
    their E blocks are zero at build time, so they scatter nothing."""
    i_stk = np.asarray(i_stk)
    j_stk = np.asarray(j_stk)
    A = i_stk.shape[0]
    plans = []
    s = 8
    for a in range(A):
        p = make_banded_plan(i_stk[a], j_stk[a], n, dh, max_block=max_block)
        if p is None:
            return None
        s = max(s, p.s)
        plans.append(p)
    if s * dh > max_block:
        return None
    plans = [
        p if p.s == s
        else make_banded_plan(i_stk[a], j_stk[a], n, dh, s=s,
                              max_block=max_block)
        for a, p in enumerate(plans)
    ]
    if any(p is None or p.dropped for p in plans):  # cannot happen: s >= bw
        return None
    return StackedBandedPlan(
        s=s, nb=plans[0].nb, n=n, dh=dh, pad_diag=plans[0].pad_diag,
        **{f: np.stack([getattr(p, f) for p in plans])
           for f in _STACKED_ARRAY_FIELDS},
    )


def build_banded_factor_stacked(
    splan: StackedBandedPlan,
    shifted_diag: jax.Array,  # (A, n, dh, dh)
    E_edges: jax.Array,  # (A, m, dh, dh)
) -> BandedFactor:
    """vmapped build_banded_factor over the agent axis: returns a
    BandedFactor whose array leaves carry a leading (A,) axis (slicing under
    a per-agent vmap recovers each agent's factor). jit-able: the scatter
    indices are static per agent, only block VALUES are runtime — GNC
    reweights rebuild the factor without recompiling."""

    def one(arrays, sd, E):
        plan = BandedPlan(
            s=splan.s, nb=splan.nb, n=splan.n, dh=splan.dh, bandwidth=0,
            pad_diag=splan.pad_diag, dropped=0,
            **dict(zip(_STACKED_ARRAY_FIELDS, arrays)),
        )
        return build_banded_factor(plan, sd, E)

    arrays = tuple(
        jnp.asarray(getattr(splan, f)) for f in _STACKED_ARRAY_FIELDS
    )
    return jax.vmap(one)(arrays, shifted_diag, E_edges)


def solve(factor: CRFactor, b: jax.Array) -> jax.Array:
    """Solve M x = b given a CRFactor. b: (n, b, r) block right-hand sides."""
    # down-sweep: fold eliminated odd blocks into the kept even equations
    odd_rhs = []
    for lv in factor.levels:
        m = b.shape[0]
        n_even = m - m // 2
        b_odd = b[1::2]
        odd_rhs.append(b_odd)
        pad = jnp.pad(b_odd, ((1, 1), (0, 0), (0, 0)))
        b = b[0::2] - jnp.einsum("kab,kbr->kar", lv.LD, pad[:n_even]) \
            - jnp.einsum("kab,kbr->kar", lv.UD, pad[1 : n_even + 1])

    x = jnp.einsum("kab,kbr->kar", factor.root_inv, b)

    # up-sweep: recover eliminated odd blocks, interleave with kept evens
    for lv, b_odd in zip(reversed(factor.levels), reversed(odd_rhs)):
        n_odd = b_odd.shape[0]
        n_even = x.shape[0]
        # odd position 2k+1 has even neighbors 2k (left) and 2k+2 (right)
        x_pad = jnp.pad(x, ((0, 1), (0, 0), (0, 0)))
        rhs = b_odd - jnp.einsum("kab,kbr->kar", lv.odd_L, x_pad[:n_odd]) \
            - jnp.einsum("kab,kbr->kar", lv.odd_U, x_pad[1 : n_odd + 1])
        x_odd = jnp.einsum("kab,kbr->kar", lv.odd_inv, rhs)
        m = n_even + n_odd
        out = jnp.zeros((m,) + x.shape[1:], x.dtype)
        out = out.at[0::2].set(x)
        out = out.at[1::2].set(x_odd)
        x = out
    return x
