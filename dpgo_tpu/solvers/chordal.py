"""Chordal initialization and odometry initialization.

Replaces the reference's SPQR-based sparse least squares
(reference: src/DPGO_solver.cpp:220-303, src/DPGO_utils.cpp:346-462) with
matrix-free preconditioned CG on the normal equations — the B1/B2/B3 matrices
of SE-Sync eq. (69) are never materialized; their normal-equation operators
are edge-gather + batched small-matmul + segment-sum, which batches on an
accelerator.

Rotation stage:   min_{Rot_i in R^{d x d}, Rot_0 = I}  sum_e kappa_e ||Rot_i R_e - Rot_j||_F^2
Translation stage: min_{t_i, t_0 = 0}                  sum_e tau_e   ||t_j - t_i - Rot_i t_e||^2

Both normal matrices are connection/graph Laplacians: SPD on the anchored
subspace, with *identity* diagonal blocks up to weighted-degree scaling
(R_e R_e^T = I), so Jacobi preconditioning is exact on the block diagonal.

Like the reference's constructBMatrices, GNC edge weights are ignored here —
only kappa/tau enter (DPGO_utils.cpp:346-433).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dpgo_tpu.measurements import EdgeArrays
from dpgo_tpu.ops import lifted


def _pcg(A, b, M, x0, tol: float, maxiter: int):
    """Minimal preconditioned conjugate gradients on a single array pytree.

    Replaces jax.scipy.sparse.linalg.cg: same math, as a plain
    lax.while_loop over one array."""
    r0 = b - A(x0)
    z0 = M(r0)
    gamma0 = jnp.vdot(r0, z0).real
    b_norm_sq = jnp.vdot(b, b).real
    tol_sq = (tol * tol) * b_norm_sq

    def cond(c):
        k, x, r, z, p, gamma, r_sq = c
        return jnp.logical_and(k < maxiter, r_sq > tol_sq)

    def body(c):
        k, x, r, z, p, gamma, r_sq = c
        Ap = A(p)
        alpha = gamma / jnp.vdot(p, Ap).real
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = jnp.vdot(r, z).real
        beta = gamma_new / gamma
        p = z + beta * p
        return (k + 1, x, r, z, p, gamma_new, jnp.vdot(r, r).real)

    init = (jnp.asarray(0, jnp.int32), x0, r0, z0, z0,
            gamma0, jnp.vdot(r0, r0).real)
    _, x, *_ = jax.lax.while_loop(cond, body, init)
    return x


@partial(jax.jit, static_argnames=("n", "tol", "maxiter"))
def _chordal_rotations(
    i: jax.Array,
    j: jax.Array,
    R: jax.Array,
    kappa: jax.Array,
    n: int,
    tol: float = 1e-10,
    maxiter: Optional[int] = 1500,
) -> jax.Array:
    """Solve the anchored rotation least squares, returning (n, d, d) blocks
    (un-projected). Pose 0 is fixed to the identity, matching the B3red
    reduction (reference: DPGO_solver.cpp:232-249)."""
    d = R.shape[-1]
    dtype = R.dtype
    free = (jnp.arange(n) > 0).astype(dtype)[:, None, None]

    # Rotation connection Laplacian in explicit block form (R R^T = I makes
    # the diagonal blocks scalar): L_ii = deg_i I, L_ij = -kappa_e R_e.
    # Same op structure as quadratic.q_matvec — one scalar-scaled term plus
    # two gathered batched matmuls and scatter-adds.
    deg = jnp.zeros((n,), dtype).at[i].add(kappa).at[j].add(kappa)
    E = kappa[:, None, None] * R  # (m, d, d)

    m = i.shape[0]

    def laplacian(Rot):
        # flat-row gathers/scatters: see quadratic.q_matvec
        Rf = Rot.reshape(n, d * d)
        Ri = Rf[i].reshape(m, d, d)
        Rj = Rf[j].reshape(m, d, d)
        ci = jnp.einsum("mab,mcb->mac", Rj, E).reshape(m, d * d)  # Rot_j E^T
        cj = jnp.einsum("mab,mbc->mac", Ri, E).reshape(m, d * d)  # Rot_i E
        outf = (deg[:, None] * Rf).at[i].add(-ci).at[j].add(-cj)
        return outf.reshape(n, d, d)

    def A(Z):
        return laplacian(Z) * free

    # Anchoring: Rot = embed(I at pose 0) + Z with Z supported on free blocks.
    anchor = jnp.zeros((n, d, d), dtype).at[0].set(jnp.eye(d, dtype=dtype))
    b = -(laplacian(anchor) * free)

    # Jacobi preconditioner: the diagonal block of the Laplacian at pose i is
    # (weighted degree) * I, since R_e R_e^T = I.
    inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, jnp.finfo(dtype).tiny), 1.0)

    def M(Z):
        return Z * inv_deg[:, None, None] * free

    Z0 = jnp.zeros((n, d, d), dtype)
    Z = _pcg(A, b, M, Z0, tol=tol, maxiter=maxiter)
    return anchor + Z


@partial(jax.jit, static_argnames=("n", "tol", "maxiter"))
def _recover_translations(
    i: jax.Array,
    j: jax.Array,
    R: jax.Array,
    t: jax.Array,
    tau: jax.Array,
    Rot: jax.Array,
    n: int,
    tol: float = 1e-10,
    maxiter: Optional[int] = 1500,
) -> jax.Array:
    """Solve the anchored translation least squares given rotations, returning
    (n, d). Pose 0 is fixed at the origin (reference: DPGO_utils.cpp:435-462)."""
    dtype = R.dtype
    free = (jnp.arange(n) > 0).astype(dtype)[:, None]

    c = jnp.einsum("mab,mb->ma", Rot[i], t)  # Rot_i t_e

    def laplacian(tv):
        res = (tv[j] - tv[i]) * tau[:, None]
        out = jnp.zeros_like(tv)
        out = out.at[j].add(res)
        out = out.at[i].add(-res)
        return out

    def A(z):
        return laplacian(z) * free

    ct = c * tau[:, None]
    b = jnp.zeros((n, R.shape[-1]), dtype).at[j].add(ct).at[i].add(-ct)
    b = b * free

    deg = jnp.zeros((n,), dtype).at[i].add(tau).at[j].add(tau)
    inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1e-300), 1.0)

    def M(z):
        return z * inv_deg[:, None] * free

    z0 = jnp.zeros((n, R.shape[-1]), dtype)
    return _pcg(A, b, M, z0, tol=tol, maxiter=maxiter)


def chordal_initialization_arrays(
    edges: EdgeArrays,
    n: Optional[int] = None,
    dtype=jnp.float64,
    tol: float = 1e-10,
    maxiter: int = 1500,
    cg_dtype=None,
) -> jax.Array:
    """Chordal initialization from edge arrays. Returns T: (n, d, d+1)
    (reference: DPGO_solver.cpp:220-269).

    cg_dtype: optionally run the two PCG stages in reduced precision (e.g.
    jnp.float32) — an *initialization* tolerates ~1e-4 accuracy. The SO(d)
    projection stays
    in `dtype` (batched SVD). Results are returned in `dtype`.
    """
    if edges.m == 0:
        raise ValueError("chordal initialization needs at least one edge")
    d = edges.d
    if n is None:
        n = int(max(edges.p1.max(), edges.p2.max())) + 1
    cg_dt = dtype if cg_dtype is None else cg_dtype
    i = jnp.asarray(edges.p1, jnp.int32)
    j = jnp.asarray(edges.p2, jnp.int32)
    R = jnp.asarray(edges.R, cg_dt)
    t = jnp.asarray(edges.t, cg_dt)
    kappa = jnp.asarray(edges.kappa, cg_dt)
    tau = jnp.asarray(edges.tau, cg_dt)

    # A bounded PCG iteration budget replaces the reference's direct SPQR
    # solve; ~500 Jacobi-preconditioned iterations reach 1e-10 agreement with
    # a fully converged solve on sphere2500, and an *initialization* feeds the
    # RTR solver anyway. Unbounded CG at tol below the attainable floor would
    # spin to the iteration cap.
    Rot = _chordal_rotations(i, j, R, kappa, n, tol=tol, maxiter=maxiter)
    Rot = lifted.project_rotation(Rot.astype(dtype))
    tv = _recover_translations(
        i, j, R, t, tau, Rot.astype(cg_dt), n, tol=tol, maxiter=maxiter
    )
    return jnp.concatenate([Rot, tv[:, :, None].astype(dtype)], axis=-1)


@partial(jax.jit, static_argnames=("n",))
def _odometry_chain(T_start: jax.Array, rel_T: jax.Array, n: int) -> jax.Array:
    """Compose a chain of homogeneous relative transforms with an O(log n)
    associative scan: T_k = T_start * rel_1 * ... * rel_k.

    rel_T: (n-1, dh, dh); returns (n, dh, dh).
    """
    seq = jnp.concatenate([T_start[None], rel_T], axis=0)
    return jax.lax.associative_scan(jnp.matmul, seq)


def odometry_initialization_arrays(
    odometry: EdgeArrays,
    n: Optional[int] = None,
    partial_trajectory: Optional[np.ndarray] = None,
    dtype=jnp.float64,
) -> jax.Array:
    """Odometry (dead-reckoning) initialization. Returns T: (n, d, d+1)
    (reference: DPGO_solver.cpp:271-303).

    `partial_trajectory`: optional (k, d, d+1) prefix to preserve; remaining
    poses are extended by composing odometry from pose k-1.
    """
    from dpgo_tpu.measurements import homogeneous

    if odometry.m == 0 and partial_trajectory is None:
        raise ValueError("empty odometry")
    d = odometry.d if odometry.m > 0 else np.asarray(partial_trajectory).shape[-2]
    if n is None:
        n = (int(odometry.p2.max()) + 1) if odometry.m > 0 else len(partial_trajectory)

    # Odometry edges must form the chain k -> k+1; sort by source index.
    order = np.argsort(np.asarray(odometry.p1))
    Rh = homogeneous(odometry.R[order], odometry.t[order])

    if partial_trajectory is not None and len(partial_trajectory) > 0:
        k = min(len(partial_trajectory), n)
        prefix = jnp.asarray(partial_trajectory[:k], dtype)
        if k >= n:
            return prefix
        Tk = lifted.se_homogeneous(prefix[k - 1])
        chain = _odometry_chain(Tk, jnp.asarray(Rh[k - 1 : n - 1], dtype), n - k + 1)
        rest = chain[1:, :d, :]
        return jnp.concatenate([prefix, rest], axis=0)

    T0 = jnp.eye(d + 1, dtype=dtype)
    chain = _odometry_chain(T0, jnp.asarray(Rh[: n - 1], dtype), n)
    return chain[:, :d, :]
