"""Batched lifted-pose manifold kernels.

The variable of the rank-relaxed PGO problem is X in (St(d, r) x R^r)^n.
We store it as a single array of shape (n, r, d+1): X[i] = [Y_i | p_i] with
Y_i an r-by-d Stiefel matrix (Y_i^T Y_i = I_d) and p_i in R^r.

These functions replace ROPTLIB's manifold layer (reference:
src/manifold/LiftedSEManifold.cpp, and DPGO_utils.cpp:464-499 projections).
They are all shape-polymorphic jit-friendly pure functions, batched over the
leading pose axis — per-pose loops (e.g. the OpenMP loop in
LiftedSEManifold.cpp:34-45) become one fused batched op.

Layout conversion: the reference flattens X to an r x (d+1)n matrix
[X_1 ... X_n]; `to_flat` / `from_flat` convert losslessly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def to_flat(X: jax.Array) -> jax.Array:
    """(n, r, d+1) -> (r, (d+1)*n) matching the reference layout
    (reference: manifold/Poses.h:16-19)."""
    n, r, dh = X.shape
    return jnp.transpose(X, (1, 0, 2)).reshape(r, n * dh)


def from_flat(Xf, n: int, d: int) -> jax.Array:
    """(r, (d+1)*n) -> (n, r, d+1)."""
    Xf = jnp.asarray(Xf)
    r = Xf.shape[0]
    return jnp.transpose(Xf.reshape(r, n, d + 1), (1, 0, 2))


def rotations(X: jax.Array) -> jax.Array:
    """Stiefel blocks Y: (n, r, d)."""
    return X[..., :-1]


def translations(X: jax.Array) -> jax.Array:
    """Translation vectors p: (n, r)."""
    return X[..., -1]


def assemble(Y: jax.Array, p: jax.Array) -> jax.Array:
    """Inverse of (rotations, translations)."""
    return jnp.concatenate([Y, p[..., None]], axis=-1)


def identity_lifted(n: int, r: int, d: int, dtype=jnp.float64) -> jax.Array:
    """Vertically-padded identity initialization (reference: Poses.cpp:14-23)."""
    Y = jnp.zeros((n, r, d), dtype).at[:, :d, :d].set(jnp.eye(d, dtype=dtype))
    p = jnp.zeros((n, r), dtype)
    return assemble(Y, p)


# ---------------------------------------------------------------------------
# Stiefel geometry (batched over all leading axes)
# ---------------------------------------------------------------------------

def _sym(M: jax.Array) -> jax.Array:
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def stiefel_proj_tangent(Y: jax.Array, V: jax.Array) -> jax.Array:
    """Orthogonal projection onto the tangent space of St(d, r) at Y:
    P_Y(V) = V - Y sym(Y^T V).

    Y^T V is spelled as a direct dot_general contracting the r axis of both
    operands (no transpose HLO feeding the dot)."""
    # HIGHEST precision unconditionally: the input's NORMAL component is
    # O(1) even when the projected result is tiny (e.g. the Euclidean
    # gradient at a critical point), so a reduced-precision f32 product
    # (TF32 on a GPU, ~1e-3 relative) would leak that much of the normal
    # component into the "tangent" output —
    # fatal for gradient-norm certification. These are per-pose (r,d)-sized
    # matmuls; HIGHEST costs nothing measurable.
    hi = jax.lax.Precision.HIGHEST
    YtV = jnp.einsum("...ra,...rb->...ab", Y, V, precision=hi)
    return V - jnp.einsum("...ra,...ab->...rb", Y, _sym(YtV), precision=hi)


def proj_tangent(X: jax.Array, V: jax.Array) -> jax.Array:
    """Tangent projection on the product manifold (St(d,r) x R^r)^n.

    Stiefel blocks are projected; translation components pass through
    (Euclidean factor)."""
    Yv = stiefel_proj_tangent(rotations(X), rotations(V))
    return assemble(Yv, translations(V))


def _qf(M: jax.Array) -> jax.Array:
    """Batched Q-factor with positive diagonal R (the "qf" retraction used by
    ROPTLIB's ChooseStieParamsSet3; reference: LiftedSEManifold.cpp:19)."""
    Q, R = jnp.linalg.qr(M)
    sign = jnp.sign(jnp.diagonal(R, axis1=-2, axis2=-1))
    sign = jnp.where(sign == 0, 1.0, sign)
    return Q * sign[..., None, :]


def retract(X: jax.Array, V: jax.Array) -> jax.Array:
    """QR retraction on the product manifold: qf(Y + V_Y) for each Stiefel
    block, p + V_p for translations."""
    Y = _qf(rotations(X) + rotations(V))
    p = translations(X) + translations(V)
    return assemble(Y, p)


def project_stiefel(M: jax.Array) -> jax.Array:
    """Batched projection onto St(d, r) via thin SVD: U V^T
    (reference: DPGO_utils.cpp:480-486)."""
    U, _, Vt = jnp.linalg.svd(M, full_matrices=False)
    return U @ Vt


def project_rotation(M: jax.Array) -> jax.Array:
    """Batched projection onto SO(d): SVD with determinant fix
    (reference: DPGO_utils.cpp:464-478)."""
    U, _, Vt = jnp.linalg.svd(M, full_matrices=False)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d = M.shape[-1]
    flip = jnp.where(det[..., None] > 0, jnp.ones(d, M.dtype),
                     jnp.ones(d, M.dtype).at[-1].set(-1.0))
    return (U * flip[..., None, :]) @ Vt


def project_lifted(X: jax.Array) -> jax.Array:
    """Project an arbitrary (n, r, d+1) array onto the lifted-pose manifold:
    each Stiefel block via SVD, translations unchanged
    (reference: LiftedSEManifold.cpp:34-45)."""
    return assemble(project_stiefel(rotations(X)), translations(X))


def project_stiefel_ns(M: jax.Array, num_iters: int = 16) -> jax.Array:
    """SVD-free Stiefel projection via the Newton-Schulz polar iteration:
    Y <- 0.5 Y (3 I - Y^T Y), converging quadratically to the polar factor
    U V^T (= the Stiefel projection) for 0 < sigma < sqrt(3).

    Blocks are pre-scaled by 1/||M||_F (an upper bound on sigma_max), making
    the iteration unconditionally safe. 8 iterations reach ~1e-13 on
    well-conditioned inputs; the default 16 covers sigma_min down to ~0.1.

    Batched matmuls only (no iterative batched SVD). Used for the Nesterov
    Y/V projections in mixed-precision mode.
    """
    d = M.shape[-1]
    s = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1), keepdims=True))
    s = jnp.maximum(s, jnp.finfo(M.dtype).tiny)
    Y0 = M / s

    # HIGHEST matmul precision is required here: with the default precision
    # a GPU may run f32 products in TF32 (~1e-3 relative), and the quadratic
    # NS iteration leaves that as orthonormality error. With full-f32
    # products the result is orthonormal to ~3e-7. (Only these two einsums need it — the
    # tCG recurrences tolerate default precision because the trust region
    # bounds step-quality loss.)
    hi = jax.lax.Precision.HIGHEST

    def body(_, Y):
        YtY = jnp.einsum("...ra,...rb->...ab", Y, Y, precision=hi)
        return 1.5 * Y - 0.5 * jnp.einsum("...ra,...ab->...rb", Y, YtY, precision=hi)

    return jax.lax.fori_loop(0, num_iters, body, Y0)


def project_lifted_ns(X: jax.Array, num_iters: int = 16) -> jax.Array:
    """project_lifted with the Newton-Schulz polar instead of SVD."""
    return assemble(project_stiefel_ns(rotations(X), num_iters), translations(X))


def project_stiefel_ns_mixed(
    M: jax.Array, num_iters: int = 16, refine_iters: int = 2
) -> jax.Array:
    """Newton-Schulz polar with the bulk of the iteration in f32 and a short
    full-precision polish.

    NS converges quadratically and its fixed
    points are exactly the orthonormal matrices: running 16 iterations in
    f32 lands ~3e-7 from the polar factor, and 2 refinement iterations in
    the input dtype drive orthonormality to ~1e-14 while staying within the
    f32 path's ~1e-7 of the true polar. Full-precision orthonormality is
    what matters downstream — f32-orthonormal Nesterov iterates floor the
    reachable global gradient norm at ~2e-2 (see parallel/spmd.py)."""
    if M.dtype == jnp.float32:
        return project_stiefel_ns(M, num_iters)
    Y = project_stiefel_ns(M.astype(jnp.float32), num_iters).astype(M.dtype)
    hi = jax.lax.Precision.HIGHEST
    for _ in range(refine_iters):
        YtY = jnp.einsum("...ra,...rb->...ab", Y, Y, precision=hi)
        Y = 1.5 * Y - 0.5 * jnp.einsum("...ra,...ab->...rb", Y, YtY, precision=hi)
    return Y


def project_lifted_ns_mixed(
    X: jax.Array, num_iters: int = 16, refine_iters: int = 2
) -> jax.Array:
    """project_lifted with the mixed-precision Newton-Schulz polar."""
    return assemble(
        project_stiefel_ns_mixed(rotations(X), num_iters, refine_iters),
        translations(X),
    )


def random_stiefel(key: jax.Array, r: int, d: int, dtype=jnp.float64) -> jax.Array:
    """Random point on St(d, r): qf of a standard Gaussian."""
    return _qf(jax.random.normal(key, (r, d), dtype))


def fixed_stiefel_variable(d: int, r: int, dtype=jnp.float64) -> jax.Array:
    """Deterministic r x d Stiefel point shared by all agents as the lifting
    matrix. The reference seeds srand(1) and uses ROPTLIB RandInManifold
    (DPGO_utils.cpp:488-493); exact bytes need not match — the required
    semantics are only (a) a valid Stiefel point, (b) identical on all agents.
    """
    return random_stiefel(jax.random.PRNGKey(1), r, d, dtype)


# ---------------------------------------------------------------------------
# Distances / norms
# ---------------------------------------------------------------------------

def inner(a: jax.Array, b: jax.Array) -> jax.Array:
    """Euclidean (Frobenius) inner product over the full product variable.
    HIGHEST: these scalars drive the tCG recurrences and every gradnorm
    test, so no backend may take them in a reduced-precision mode."""
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def norm(a: jax.Array) -> jax.Array:
    return jnp.sqrt(inner(a, a))


def max_translation_distance(X1: jax.Array, X2: jax.Array) -> jax.Array:
    """max_i ||p1_i - p2_i|| (reference: Poses.cpp:86-94) — the relative-change
    metric used for local termination (PGOAgent.cpp:406)."""
    diff = translations(X1) - translations(X2)
    return jnp.max(jnp.linalg.norm(diff, axis=-1))


def average_translation_distance(X1: jax.Array, X2: jax.Array) -> jax.Array:
    """mean_i ||p1_i - p2_i|| (reference: Poses.cpp:75-84)."""
    diff = translations(X1) - translations(X2)
    return jnp.mean(jnp.linalg.norm(diff, axis=-1))


# ---------------------------------------------------------------------------
# SE(d) pose utilities (T: (..., d, d+1))
# ---------------------------------------------------------------------------

def se_identity(n: int, d: int, dtype=jnp.float64) -> jax.Array:
    """(n, d, d+1) array of identity poses."""
    T = jnp.zeros((n, d, d + 1), dtype)
    return T.at[:, :, :d].set(jnp.eye(d, dtype=dtype))


def se_inverse(T: jax.Array) -> jax.Array:
    """Batched SE(d) inverse: [R, t] -> [R^T, -R^T t]
    (reference: Poses.cpp:110-118)."""
    R = T[..., :, :-1]
    t = T[..., :, -1]
    Rt = jnp.swapaxes(R, -1, -2)
    return jnp.concatenate([Rt, -(Rt @ t[..., None])], axis=-1)


def se_compose(Ta: jax.Array, Tb: jax.Array) -> jax.Array:
    """Batched SE(d) composition [Ra, ta] * [Rb, tb] = [Ra Rb, Ra tb + ta]."""
    Ra = Ta[..., :, :-1]
    ta = Ta[..., :, -1]
    Rb = Tb[..., :, :-1]
    tb = Tb[..., :, -1]
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return jnp.concatenate([R, t[..., None]], axis=-1)


def se_homogeneous(T: jax.Array) -> jax.Array:
    """(..., d, d+1) -> homogeneous (..., d+1, d+1)."""
    d = T.shape[-2]
    pad_shape = T.shape[:-2] + (1, d + 1)
    bottom = jnp.zeros(pad_shape, T.dtype).at[..., 0, d].set(1.0)
    return jnp.concatenate([T, bottom], axis=-2)


def check_stiefel(Y, atol: float = 1e-5) -> bool:
    """Host-side validity check (reference: DPGO_utils.cpp:530-538)."""
    Y = np.asarray(Y)
    d = Y.shape[-1]
    err = np.linalg.norm(
        np.swapaxes(Y, -1, -2) @ Y - np.eye(d), axis=(-2, -1)
    )
    return bool(np.all(err < atol))


def check_rotation(R, atol: float = 1e-5) -> bool:
    """Host-side validity check (reference: DPGO_utils.cpp:518-528)."""
    R = np.asarray(R)
    if not check_stiefel(R, atol):
        return False
    return bool(np.all(np.abs(np.linalg.det(R) - 1.0) < atol))
