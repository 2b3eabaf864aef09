"""Anchored delta-state RBCD: certified f64-class accuracy at scale with
ZERO f64 tensor kernels on device.

Why this exists. A plain f32 iterate cannot certify the reference-quality
global gradient norm (< 1e-2) at 100k poses: quantizing the pose values to
f32 perturbs the iterate by ~eps_f32·|X| per entry, and the gradient at the
perturbed point differs by ~||Hess||·eps·|X|·sqrt(n·deg). Measured on the
synthetic grid3d world (scripts/f32_floor_experiment.py): the quantization
alone contributes 3.5e-3 to the global gradnorm at 10k poses — extrapolating
(sqrt(10)× poses, 2× translation extent) puts the 100k floor at ~2e-2,
above the target. On a device with native f64 the plain engine in f64 is
the alternative; whether this engine's f32 bytes beat it is a measurement
still to be made on the GPU.

The fix: never materialize the pose values in f32. The iterate is stored as
X = X_ref + D where

  * X_ref is an anchor held in f64 ON THE HOST (numpy); the device sees an
    f32 cast of it plus f64-precomputed per-edge REFERENCE RESIDUALS
    Res_ref = X_ref_i·T − X_ref_j (small near convergence) and the
    orthonormality defects M_ref = Y_refᵀY_ref − I;
  * D is the f32 on-device delta — small, so f32 resolution eps·|D| applies
    to the DELTA, not to O(|X|) pose values;
  * every device-side computation touches only small quantities:
      - residuals:   Res = Res_ref + (D_i·T − D_j)            (edge-local)
      - gradient:    per-edge contributions (Res·om)Tᵀ etc.   (residual form)
      - cost change: f(X') − f(X) = ½⟨Δ, g + g'⟩              (exact for the
        quadratic objective — no difference of large costs, no extra matvec)
      - retraction/projection: the POLAR map in delta form — the
        Newton–Schulz polar iteration rewritten on the delta E = Y − Y_ref:
        E ← E − ½·(Y_ref+E)·K(E),  K(E) = M_ref + Y_refᵀE + EᵀY_ref + EᵀE,
        every term O(|E| + |M_ref|); the O(1) identity is never formed, so
        the injected rounding is eps·|W|, not eps·|X| (delta_polar). Because
        K is recomputed from M_ref and the actual E each iteration,
        approximate projections do NOT compound: the algebra never assumes
        Y is exactly orthonormal.
  * every chunk of rounds the host RE-ANCHORS in f64: X_ref += D, D → 0
    (Nesterov variables shift exactly: D_V − D_X, D_Y − D_X), and the
    reference residuals/defects are recomputed — so |D| stays at the scale
    of recent steps and the representable iterate resolution keeps
    improving as the optimization converges.

Certification is honest: the final gradient norm is evaluated in f64 on the
host at X_ref + D (run_delta_certified returns it alongside the iterate).

This engine is the tail/certification phase of the 100k-scale pipeline; the
plain f32 SPMD engine (parallel/spmd.py) handles the bulk descent where the
quantization floor is irrelevant. Deviation from the reference: the local
solver here uses the polar retraction (second-order) instead of ROPTLIB's
qf/QR retraction (LiftedSEManifold.cpp:19) — any retraction yields a valid
RTR; documented in docs/PARITY.md.

Robust (GNC-TLS) and elastic runs work at certified quality too: the engine
already carries per-edge residuals in residual form, so GNC reweighting
(delta_gnc_reweight / run_delta_gnc — reference semantics
PGOAgent.cpp:997-1142) costs one extra residual evaluation per weight
update, and the runtime robot_active mask freezes inactive agents' blocks
and drops their shared edges exactly as the main engine does
(_delta_round; reference PGOAgent.cpp:1173-1184).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dpgo_tpu import quadratic
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel import spmd as spmd_mod
from dpgo_tpu.solvers import rtr as rtr_mod

_HI = jax.lax.Precision.HIGHEST


class DeltaRef(NamedTuple):
    """Device-side (f32) anchor data, precomputed in f64 on the host."""

    X_ref: jax.Array  # (N, n_max, r, dh)
    res_ref_priv: jax.Array  # (N, mp, r, dh)
    res_ref_shared: jax.Array  # (N, ms, r, dh)
    M_ref: jax.Array  # (N, n_max, d, d)  Y_refᵀY_ref − I


class DeltaState(NamedTuple):
    D: jax.Array  # (N, n_max, r, dh) delta of X
    DY: jax.Array  # delta of the Nesterov aux Y
    DV: jax.Array  # delta of the Nesterov aux V
    ACC: jax.Array  # (N, n_max, r, dh) sum of anchor folds since the HOST
    #               anchor: current point = X_base64 + ACC + D. |ACC| is the
    #               total phase-2 displacement (small near convergence), so
    #               its f32 resolution is far below the certification target.
    gamma: jax.Array
    it: jax.Array
    prev_cost: jax.Array  # last round's objective (adaptive restart signal)
    do_restart: jax.Array  # bool: cost increased last round -> restart now


def build_delta_ref(
    problem: spmd_mod.SPMDProblem, X_ref64: np.ndarray, dtype=np.float32
) -> DeltaRef:
    """Host-side, f64: reference residuals + orthonormality defects at the
    anchor. X_ref64: (N, n_max, r, dh) float64."""
    X = np.asarray(X_ref64, np.float64)
    N, n_max, r, dh = X.shape
    d = dh - 1
    T = np.asarray(problem.priv_T, np.float64)
    i_idx = np.asarray(problem.priv_i)
    j_idx = np.asarray(problem.priv_j)
    Xi = np.take_along_axis(X, i_idx[:, :, None, None], axis=1)
    Xj = np.take_along_axis(X, j_idx[:, :, None, None], axis=1)
    res_priv = np.einsum("qmra,qmab->qmrb", Xi, T, optimize=True) - Xj

    # shared edges: resolve the neighbor's reference pose globally
    pub = np.take_along_axis(
        X, np.asarray(problem.pub_idx)[:, :, None, None], axis=1
    )  # (N, p_max, r, dh)
    nbr = pub[np.asarray(problem.shared_nbr_robot),
              np.asarray(problem.shared_nbr_slot)]  # (N, ms, r, dh)
    Xl = np.take_along_axis(
        X, np.asarray(problem.shared_idx)[:, :, None, None], axis=1
    )
    Ts = np.asarray(problem.shared_T, np.float64)
    out = np.asarray(problem.shared_outgoing)[:, :, None, None]
    tail = np.where(out, Xl, nbr)
    head = np.where(out, nbr, Xl)
    res_shared = np.einsum("qmra,qmab->qmrb", tail, Ts, optimize=True) - head

    Y = X[..., :d]
    M = np.einsum("qnra,qnrb->qnab", Y, Y, optimize=True) - np.eye(d)

    return DeltaRef(
        X_ref=jnp.asarray(X, dtype),
        res_ref_priv=jnp.asarray(res_priv, dtype),
        res_ref_shared=jnp.asarray(res_shared, dtype),
        M_ref=jnp.asarray(M, dtype),
    )


def initial_delta_state(ref: DeltaRef) -> DeltaState:
    z = jnp.zeros_like(ref.X_ref)
    return DeltaState(
        D=z, DY=z, DV=z, ACC=z,
        gamma=jnp.zeros((), ref.X_ref.dtype),
        it=jnp.zeros((), jnp.int32),
        prev_cost=jnp.asarray(jnp.inf, ref.X_ref.dtype),
        do_restart=jnp.asarray(False),
    )


# ---------------------------------------------------------------------------
# The delta-polar primitive
# ---------------------------------------------------------------------------

def _delta_K(Y_ref: jax.Array, M_ref: jax.Array, E: jax.Array) -> jax.Array:
    """K = (Y_ref+E)ᵀ(Y_ref+E) − I, computed CANCELLATION-FREE as
    M_ref + Y_refᵀE + EᵀY_ref + EᵀE — the O(1) identity never appears, so
    the absolute rounding is eps·(|M_ref| + |E|), not eps·1."""
    YtE = jnp.einsum("...ra,...rb->...ab", Y_ref, E, precision=_HI)
    EtE = jnp.einsum("...ra,...rb->...ab", E, E, precision=_HI)
    return M_ref + YtE + jnp.swapaxes(YtE, -1, -2) + EtE


def delta_polar(Y_ref: jax.Array, M_ref: jax.Array, W: jax.Array,
                iters: int = 16) -> jax.Array:
    """polar(Y_ref + W) − Y_ref, computed entirely in delta space.

    Newton–Schulz polar iteration Y ← Y − ½·Y·(YᵀY − I), rewritten on the
    delta E = Y − Y_ref:  E ← E − ½·(Y_ref + E)·K(E)  with K(E) recomputed
    cancellation-free each step (_delta_K). The fixed points are exactly
    E with (Y_ref+E) orthonormal; near convergence every operand is small,
    so the injected rounding is eps·(|W| + |M_ref|) — never eps·|Y|. Works
    for any anchor (M_ref carries its orthonormality defect) and does not
    assume |W| small: a delta-compatible pre-scaling
    c·A = Y_ref + ((c−1)·Y_ref + c·W) clamps σ_max(A) into NS's basin
    (σ < √3) and is the identity (c = 1, exactly) whenever W is already
    moderate — i.e. always near convergence, where delta accuracy matters.
    Shapes: Y_ref/W (..., r, d), M_ref (..., d, d)."""
    d = W.shape[-1]
    K0 = _delta_K(Y_ref, M_ref, W)
    # σ_max(A)² = 1 + λ_max(K) ≤ 1 + ||K||_F; clamp σ² to ≤ 2 (inside the
    # NS basin σ² < 3) by shrinking A when needed — c = 1 exactly otherwise
    s2 = 1.0 + jnp.sqrt(
        jnp.sum(K0 * K0, axis=(-2, -1), keepdims=True)
    )
    c = jnp.minimum(1.0, jnp.sqrt(2.0 / s2))
    E = (c - 1.0) * Y_ref + c * W
    c2 = c * c
    # K of the scaled matrix: (c²−1)·I + c²·K — still cancellation-free
    K = (c2 - 1.0) * jnp.eye(d, dtype=W.dtype) + c2 * K0

    # NS converges quadratically (K ← ~¾K² once ||K|| < 1): stop when every
    # block's orthonormality defect reaches the f32 floor instead of always
    # unrolling the worst case — in the RBCD tail W is a tiny perturbation of
    # the manifold point, so 3-5 iterations replace 16.
    # The body UNROLLS 3 NS steps per convergence check: each while_loop
    # iteration pays a predicate sync + small-kernel launch tax that dwarfs
    # the ~1 MFLOP of arithmetic at 3x2 blocks, and the max-reduction cond is
    # a full-array pass — checking every 3 steps fuses three bodies into one
    # kernel chain and cuts the reductions 3x. Overshoot past
    # convergence is harmless: at the fixed point an NS step is the identity
    # plus eps·|E| rounding, the same floor the tolerance already encodes.
    tol_sq = jnp.asarray(3e-7**2, W.dtype)
    UNROLL = 3

    def cond(c_):
        _E, K_, it = c_
        return jnp.logical_and(
            it < iters, jnp.max(jnp.sum(K_ * K_, axis=(-2, -1))) > tol_sq
        )

    def body(c_):
        E_, K_, it = c_
        for _ in range(UNROLL):
            A = Y_ref + E_
            E_ = E_ - 0.5 * jnp.einsum(
                "...ra,...ab->...rb", A, K_, precision=_HI
            )
            K_ = _delta_K(Y_ref, M_ref, E_)
        return (E_, K_, it + UNROLL)

    E, _K, _ = jax.lax.while_loop(
        cond, body, (E, K, jnp.asarray(0, jnp.int32))
    )
    return E


def delta_polar2(Y_ref: jax.Array, M_ref: jax.Array,
                 W: jax.Array) -> jax.Array:
    """polar(Y_ref + W) − Y_ref for d = 2, in CLOSED FORM — no iteration.

    With A = Y_ref + W and S = AᵀA = I + K (K from _delta_K,
    cancellation-free), the 2×2 principal square root is
    S^½ = (S + s·I)/q with s = √det S, q = √(tr S + 2s), so S^½ = I + B
    where B = (det K / (q(q+1+s)))·I + K/q — the identity
    q − (1+s) = −det K / (q+1+s) keeps B O(K) with no 1−1 subtraction.
    Then N := S^{−½} − I = −B·((1+tr B)·I − B) / (1 + tr B + det B)
    (2×2 adjugate inverse), and the delta update
    E′ = Y_ref·N + E + E·N is O(|W| + |K|) throughout: the rounding floor
    matches converged Newton–Schulz, but the whole projection is ~30
    elementwise ops that XLA fuses into one kernel chain, with no
    per-iteration launch and reduction tax. Works for ANY S ≻ 0 (no
    convergence basin, no pre-scale clamp). All 2×2 algebra is
    component-unrolled: batched 2×2 einsums lower to dot_general layout
    shuffles that dwarf the arithmetic at this size."""
    E = W
    # K entries, component-unrolled (K is symmetric: k01 == k10)
    y0, y1 = Y_ref[..., 0], Y_ref[..., 1]  # (..., r) columns
    e0, e1 = E[..., 0], E[..., 1]
    k00 = M_ref[..., 0, 0] + jnp.sum(2.0 * y0 * e0 + e0 * e0, axis=-1)
    k11 = M_ref[..., 1, 1] + jnp.sum(2.0 * y1 * e1 + e1 * e1, axis=-1)
    k01 = M_ref[..., 0, 1] + jnp.sum(
        y0 * e1 + y1 * e0 + e0 * e1, axis=-1
    )
    trK = k00 + k11
    detK = k00 * k11 - k01 * k01
    u = trK + detK  # det S − 1
    s = jnp.sqrt(jnp.maximum(1.0 + u, 0.0))  # √det S (S ⪰ 0 by construction)
    q = jnp.sqrt(jnp.maximum(2.0 + trK + 2.0 * s, 0.0))  # √(tr S + 2s)
    # B = S^½ − I
    bdiag = detK / (q * (q + 1.0 + s))
    b00 = bdiag + k00 / q
    b11 = bdiag + k11 / q
    b01 = k01 / q
    # N = (I+B)^{−1} − I = −B·((1+trB)·I − B)/det(I+B)
    trB = b00 + b11
    detIB = 1.0 + trB + (b00 * b11 - b01 * b01)
    inv = 1.0 / detIB
    c = 1.0 + trB
    n00 = -(b00 * (c - b00) - b01 * b01) * inv
    n11 = -(b11 * (c - b11) - b01 * b01) * inv
    n01 = -(b01 * (c - b11) - b00 * b01) * inv
    # E′ = Y·N + E + E·N, columns unrolled
    a0 = y0 + e0
    a1 = y1 + e1
    out0 = e0 + a0 * n00[..., None] + a1 * n01[..., None]
    out1 = e1 + a0 * n01[..., None] + a1 * n11[..., None]
    # One Newton–Schulz polish step: the closed form's division/sqrt chain
    # loses ~3 digits in f32 when |W| is large (post-restart extrapolations);
    # a single NS step squares the defect (4e-4 → ~1e-7, the NS tolerance
    # floor) and stays inside the same fused elementwise chain.
    e0, e1 = out0, out1
    k00 = M_ref[..., 0, 0] + jnp.sum(2.0 * y0 * e0 + e0 * e0, axis=-1)
    k11 = M_ref[..., 1, 1] + jnp.sum(2.0 * y1 * e1 + e1 * e1, axis=-1)
    k01 = M_ref[..., 0, 1] + jnp.sum(y0 * e1 + y1 * e0 + e0 * e1, axis=-1)
    a0 = y0 + e0
    a1 = y1 + e1
    out0 = e0 - 0.5 * (a0 * k00[..., None] + a1 * k01[..., None])
    out1 = e1 - 0.5 * (a0 * k01[..., None] + a1 * k11[..., None])
    return jnp.stack([out0, out1], axis=-1)


def delta_project_lifted(X_ref, M_ref, W):
    """Lifted-pose delta projection: polar on the rotation block, identity on
    the translation column (mirrors lifted.project_lifted). d = 2 uses the
    closed-form 2×2 polar (delta_polar2); d = 3 the Newton–Schulz iteration
    (delta_polar)."""
    if W.shape[-1] - 1 == 2:
        W_rot = delta_polar2(X_ref[..., :-1], M_ref, W[..., :-1])
    else:
        W_rot = delta_polar(X_ref[..., :-1], M_ref, W[..., :-1])
    return jnp.concatenate([W_rot, W[..., -1:]], axis=-1)


# ---------------------------------------------------------------------------
# Residual-form cost/gradient in delta space
# ---------------------------------------------------------------------------

def _lanes_usable(problem: spmd_mod.SPMDProblem) -> bool:
    """Host-side, static: can the banded prefix of the private edges use the
    lane-structured residual evaluator? Requires band lanes to exist and no
    two positive-weight banded edges of any agent sharing a (lane, i) slot —
    the lane arrays hold one edge per slot (the Q matvec can MERGE duplicate
    E blocks, but residuals are per-edge: res_ref differs per measurement)."""
    nb = problem.num_band
    if nb == 0 or not problem.band_offsets or problem.n_max <= 1:
        return False
    i = np.asarray(problem.priv_i[:, :nb])
    ln = np.asarray(problem.priv_lane[:, :nb])
    w = np.asarray(problem.priv_weight[:, :nb])
    n = problem.n_max
    for a in range(i.shape[0]):
        flat = ln[a][w[a] > 0] * np.int64(n) + i[a][w[a] > 0]
        if len(np.unique(flat)) != len(flat):
            return False
    return True


def _build_lane_data(pi, pl, pT, op, res_ref, w, n: int, L: int):
    """One agent's lane-structured banded-edge data (runtime values, static
    shapes). Scatters the banded prefix into per-lane per-row slots; padded
    and zero-weight edges go to a dump row. Returns
    (T_lane (L,n,dh,dh), om_lane (L,n,dh), res_lane (L,n,r,dh))."""
    nb = pi.shape[0]
    dh = pT.shape[-1]
    r = res_ref.shape[-2]
    dt = pT.dtype
    flat = jnp.where(w > 0, pl * n + pi, L * n)
    T_lane = (
        jnp.zeros((L * n + 1, dh, dh), dt).at[flat].add(pT)[:-1]
        .reshape(L, n, dh, dh)
    )
    om_lane = (
        jnp.zeros((L * n + 1, dh), dt).at[flat].add(op)[:-1].reshape(L, n, dh)
    )
    res_lane = (
        jnp.zeros((L * n + 1, r, dh), dt).at[flat].add(res_ref)[:-1]
        .reshape(L, n, r, dh)
    )
    return T_lane, om_lane, res_lane


def _lane_cost_grad(lanes, offs: jax.Array, D: jax.Array):
    """Banded-edge residual cost + Euclidean gradient via lane-structured
    shifted dense ops — the residual-path mirror of quadratic.q_matvec's
    band form: two batched einsums + two structured gathers, zero
    scatter-adds. Garbage at rows without a lane edge (T_lane = 0,
    res_lane = 0, but D[i+delta] finite) is annihilated by om_lane = 0.
    Returns (cost, G (n,r,dh))."""
    T_lane, om_lane, res_lane = lanes
    L, n = om_lane.shape[:2]
    _, r, dh = D.shape
    iota = jnp.arange(n, dtype=jnp.int32)
    up = jnp.clip(iota[None, :] + offs[:, None], 0, n - 1)  # (L, n)
    Dj = D[up.reshape(-1)].reshape(L, n, r, dh)
    Res = res_lane + (
        jnp.einsum("nrb,lnbc->lnrc", D, T_lane, precision=_HI) - Dj
    )
    Rw = Res * om_lane[:, :, None, :]
    cost = jnp.vdot(Res, Rw, precision=_HI)
    # G[i] += Rw @ T^T (rows without an edge have Rw = 0)
    G = jnp.einsum("lnrb,lncb->nrc", Rw, T_lane, precision=_HI)
    # G[j] -= Rw[l, j - delta_l] (out-of-range gathers the appended zero row)
    pad = jnp.concatenate(
        [Rw.reshape(L * n, r, dh), jnp.zeros((1, r, dh), Rw.dtype)]
    )
    down = iota[None, :] - offs[:, None]  # (L, n)
    flat = jnp.where(
        (down >= 0) & (down < n),
        jnp.arange(L, dtype=jnp.int32)[:, None] * n + down,
        L * n,
    )
    G = G - jnp.sum(pad[flat.reshape(-1)].reshape(L, n, r, dh), axis=0)
    return cost, G


def _omegas(pr_blk: spmd_mod.SPMDProblem):
    d = pr_blk.d
    om_p = quadratic._omega(
        pr_blk.priv_kappa.reshape(-1), pr_blk.priv_tau.reshape(-1),
        pr_blk.priv_weight.reshape(-1), d,
    ).reshape(*pr_blk.priv_kappa.shape, d + 1)
    om_s = quadratic._omega(
        pr_blk.shared_kappa.reshape(-1), pr_blk.shared_tau.reshape(-1),
        pr_blk.shared_weight.reshape(-1), d,
    ).reshape(*pr_blk.shared_kappa.shape, d + 1)
    return om_p, om_s


def _delta_cost_grad(
    ref_a,  # per-agent slices of DeltaRef (REST edges when lanes are on)
    priv,  # (i, j, T, om) — REST (non-banded) edges when lanes are on
    shared,  # (idx, T, om, outgoing)
    D: jax.Array,  # (n, r, dh) this agent's delta
    nbrD: jax.Array,  # (ms, r, dh) neighbor deltas per shared edge
    lanes=None,  # ((T_lane, om_lane, res_lane), offs) banded-prefix lane data
):
    """One agent's objective pieces and Euclidean gradient at X_ref + D, all
    from residuals: Res = Res_ref + ΔRes with ΔRes edge-local in the deltas.
    Returns (cost_metric, eg) where cost_metric attributes shared edges to
    the outgoing side (team psum == global objective, matching
    spmd._edge_cost_terms convention: no 0.5 factor)."""
    res_ref_p, res_ref_s = ref_a
    pi, pj, pT, om_p = priv
    sidx, sT, om_s, sout = shared
    n, r, dh = D.shape
    m = pi.shape[0]
    Df = D.reshape(n, r * dh)

    if lanes is not None:
        lane_data, offs = lanes
        cost, G = _lane_cost_grad(lane_data, offs, D)
        G = G.reshape(n, r * dh)
    else:
        cost = jnp.zeros((), D.dtype)
        G = jnp.zeros((n, r * dh), D.dtype)
    Di = Df[pi].reshape(m, r, dh)
    Dj = Df[pj].reshape(m, r, dh)
    Res = res_ref_p + jnp.einsum("mra,mab->mrb", Di, pT, precision=_HI) - Dj
    Rw = Res * om_p[:, None, :]
    cost = cost + jnp.vdot(Res, Rw, precision=_HI)
    gi = jnp.einsum("mrb,mab->mra", Rw, pT, precision=_HI)
    G = G.at[pi].add(gi.reshape(m, r * dh))
    G = G.at[pj].add(-Rw.reshape(m, r * dh))

    ms = sidx.shape[0]
    if ms > 0:
        Dl = Df[sidx].reshape(ms, r, dh)
        out_f = sout[:, None, None]
        tailD = jnp.where(out_f, Dl, nbrD)
        headD = jnp.where(out_f, nbrD, Dl)
        Res_s = res_ref_s + (
            jnp.einsum("mra,mab->mrb", tailD, sT, precision=_HI) - headD
        )
        Rw_s = Res_s * om_s[:, None, :]
        cost = cost + jnp.vdot(
            Res_s * sout[:, None, None].astype(D.dtype), Rw_s, precision=_HI
        )
        contrib = jnp.where(
            out_f,
            jnp.einsum("mrb,mab->mra", Rw_s, sT, precision=_HI),
            -Rw_s,
        )
        G = G.at[sidx].add(contrib.reshape(ms, r * dh))

    return cost, G.reshape(n, r, dh)


# ---------------------------------------------------------------------------
# Per-agent delta RTR (shrink-until-accept, the RBCD step mode)
# ---------------------------------------------------------------------------

def _delta_rtr_step(
    qd,  # QuadraticData (f32) for the tCG Hessian/preconditioner
    ref_X,  # (n, r, dh) anchor slice
    ref_M,  # (n, d, d)
    ref_res,  # (res_ref_priv_a, res_ref_shared_a)
    priv, shared,
    D0: jax.Array,
    nbrD: jax.Array,
    cfg: spmd_mod.SPMDConfig,
    lanes=None,
):
    """One shrink-until-accept RTR iteration in delta space (the reference's
    per-RBCD-step mode, QuadraticOptimizer.cpp:80-98). Returns
    (D_new, gnorm0, cost0)."""
    dtype = D0.dtype
    X0 = ref_X + D0  # f32 point: used only where relative accuracy suffices
    cost0, eg0 = _delta_cost_grad(ref_res, priv, shared, D0, nbrD, lanes)
    grad0 = lifted.proj_tangent(X0, eg0)
    gnorm0 = lifted.norm(grad0)
    S0 = quadratic.hess_correction(X0, eg0)

    def cond(c):
        accepted, attempts, _D, _radius = c
        return jnp.logical_and(
            jnp.logical_not(accepted), attempts <= rtr_mod._MAX_SHRINKS
        )

    def body(c):
        _accepted, attempts, _D, radius = c
        tcg = rtr_mod._tcg(
            qd, X0, S0, grad0, radius, cfg.rtr_tcg_iterations,
            precision=(
                jax.lax.Precision.HIGHEST
                if cfg.rtr_tcg_precision == "highest"
                else jax.lax.Precision.HIGH
                if cfg.rtr_tcg_precision == "high"
                else None
            ),
        )
        eta = lifted.proj_tangent(X0, tcg.eta)
        D_new = delta_project_lifted(ref_X, ref_M, D0 + eta)
        step = D_new - D0  # ambient step, exact in f32 (difference of deltas)
        _c1, eg1 = _delta_cost_grad(ref_res, priv, shared, D_new, nbrD, lanes)
        # exact-for-quadratics decrease: f(X′) − f(X) = ½⟨Δ, g + g′⟩ — both
        # gradients are residual-accurate, Δ is small: cancellation-free
        df = 0.5 * (lifted.inner(step, eg0) + lifted.inner(step, eg1))
        model_decrease = -(
            lifted.inner(grad0, tcg.eta) + 0.5 * lifted.inner(tcg.eta, tcg.Heta)
        )
        # rho WITHOUT numerator inflation: df is cancellation-free (unlike
        # the main engine's f(X')−f(X) subtraction), so a true cost increase
        # must be rejected — inflating it with a cost-scaled reg would accept
        # noise steps near convergence, which Nesterov then amplifies. The
        # denominator guard only avoids 0/0 (Steihaug model decrease >= 0).
        rho = -df / jnp.maximum(model_decrease, jnp.finfo(dtype).tiny)
        accept = rho > rtr_mod._RHO_PRIME
        return (
            accept,
            attempts + 1,
            jnp.where(accept, D_new, D0),
            jnp.where(accept, radius, 0.25 * radius),
        )

    init = (
        jnp.asarray(False), jnp.asarray(0, jnp.int32), D0,
        jnp.asarray(cfg.rtr_initial_radius, dtype),
    )
    # pre-apply the first attempt OUTSIDE the while_loop: cond(init) is
    # always true (accepted=False, attempts=0), so while(cond, body,
    # body(init)) is exactly equivalent — but the common case (accept on
    # attempt 1, the Jacobi-parallel steady state) now runs ZERO loop
    # iterations, so the tCG + cost_grad of the attempt fuse into the
    # surrounding round instead of sitting behind a while_loop barrier
    # that forces the carry through device memory.
    _acc, _att, D_out, _rad = jax.lax.while_loop(cond, body, body(init))
    # no optimization needed if already below the local tolerance
    D_out = jnp.where(gnorm0 < cfg.rtr_gradnorm_tol, D0, D_out)
    # eg0 (the ambient Euclidean half-gradient at the evaluation point,
    # already in hand) is returned for the restart schemes that need a
    # cancellation-free signal (see _delta_round): 'gradient' takes its
    # inner product with the step; 'exact' combines it with one Q matvec on
    # the small W = (x-Y)+(x'-Y) to reproduce f(x')-f(x) exactly.
    return D_out, gnorm0, cost0, eg0


# ---------------------------------------------------------------------------
# The delta round + fused driver
# ---------------------------------------------------------------------------

class CarryRef(NamedTuple):
    """Loop-carried anchor data. Unlike DeltaRef (the host I/O form), the
    banded prefix's reference residuals live in LANE layout (res_lane) when
    the lane path is on, and res_rest holds only the non-banded edges."""

    X_ref: jax.Array  # (A, n, r, dh)
    M_ref: jax.Array  # (A, n, d, d)
    res_rest: jax.Array  # (A, m_rest, r, dh)
    res_shared: jax.Array  # (A, ms, r, dh)
    res_lane: Optional[jax.Array]  # (A, L, n, r, dh) or None


def _nb_of(problem, use_lanes: bool) -> int:
    return problem.num_band if use_lanes else 0


def _make_carry_ref(pr_blk, ref_blk: DeltaRef, om_p, use_lanes: bool):
    """DeltaRef -> CarryRef (scatter the banded prefix into lane layout)."""
    nb = _nb_of(pr_blk, use_lanes)
    if nb == 0:
        return CarryRef(
            X_ref=ref_blk.X_ref, M_ref=ref_blk.M_ref,
            res_rest=ref_blk.res_ref_priv, res_shared=ref_blk.res_ref_shared,
            res_lane=None,
        )
    L = len(pr_blk.band_offsets)
    n = pr_blk.n_max

    def one(pi, pl, w, res):
        r, dh = res.shape[-2:]
        flat = jnp.where(w > 0, pl * n + pi, L * n)
        return (
            jnp.zeros((L * n + 1, r, dh), res.dtype).at[flat].add(res)[:-1]
            .reshape(L, n, r, dh)
        )

    res_lane = jax.vmap(one)(
        pr_blk.priv_i[:, :nb], pr_blk.priv_lane[:, :nb],
        pr_blk.priv_weight[:, :nb], ref_blk.res_ref_priv[:, :nb],
    )
    return CarryRef(
        X_ref=ref_blk.X_ref, M_ref=ref_blk.M_ref,
        res_rest=ref_blk.res_ref_priv[:, nb:],
        res_shared=ref_blk.res_ref_shared,
        res_lane=res_lane,
    )


def _carry_to_delta_ref(pr_blk, ref: CarryRef, use_lanes: bool) -> DeltaRef:
    """CarryRef -> DeltaRef (gather the lane layout back to edge order).
    Padded / zero-weight banded edges come back as 0 — their residuals are
    never used (omega = 0)."""
    nb = _nb_of(pr_blk, use_lanes)
    if nb == 0:
        return DeltaRef(
            X_ref=ref.X_ref, res_ref_priv=ref.res_rest,
            res_ref_shared=ref.res_shared, M_ref=ref.M_ref,
        )
    L = len(pr_blk.band_offsets)
    n = pr_blk.n_max

    def one(pi, pl, w, res_lane):
        r, dh = res_lane.shape[-2:]
        flat = jnp.where(w > 0, pl * n + pi, L * n)
        pad = jnp.concatenate(
            [res_lane.reshape(L * n, r, dh),
             jnp.zeros((1, r, dh), res_lane.dtype)]
        )
        return pad[flat]

    res_prefix = jax.vmap(one)(
        pr_blk.priv_i[:, :nb], pr_blk.priv_lane[:, :nb],
        pr_blk.priv_weight[:, :nb], ref.res_lane,
    )
    return DeltaRef(
        X_ref=ref.X_ref,
        res_ref_priv=jnp.concatenate([res_prefix, ref.res_rest], axis=1),
        res_ref_shared=ref.res_shared, M_ref=ref.M_ref,
    )


def _build_lane_static(pr_blk, om_p, use_lanes: bool):
    """Round-invariant per-agent lane arrays (T_lane, om_lane) or None."""
    nb = _nb_of(pr_blk, use_lanes)
    if nb == 0:
        return None
    L = len(pr_blk.band_offsets)
    n = pr_blk.n_max

    def one(pi, pl, w, pT, op):
        dh = pT.shape[-1]
        flat = jnp.where(w > 0, pl * n + pi, L * n)
        T_lane = (
            jnp.zeros((L * n + 1, dh, dh), pT.dtype).at[flat].add(pT)[:-1]
            .reshape(L, n, dh, dh)
        )
        om_lane = (
            jnp.zeros((L * n + 1, dh), op.dtype).at[flat].add(op)[:-1]
            .reshape(L, n, dh)
        )
        return T_lane, om_lane

    return jax.vmap(one)(
        pr_blk.priv_i[:, :nb], pr_blk.priv_lane[:, :nb],
        pr_blk.priv_weight[:, :nb], pr_blk.priv_T[:, :nb], om_p[:, :nb],
    )


def _fold_anchor(pr_blk, axis_name, ref: CarryRef, state: DeltaState,
                 lane_static, use_lanes: bool) -> Tuple[CarryRef, DeltaState]:
    """On-device re-anchor: fold D into the anchor ENTIRELY in delta space.

    res_ref' = res_ref + ΔRes(D) (error eps·|res| — relative to the residual
    scale, like every other delta-path quantity); M_ref' = K(D_rot) via the
    cancellation-free _delta_K, consistent with the folded anchor by
    construction; X_ref' = X_ref + D is only the f32 WITNESS of the anchor
    (used where relative accuracy suffices); ACC' = ACC + D lets the host
    reconstruct the true point as X_base64 + ACC + D without any per-fold
    host round-trip."""
    pr = pr_blk
    nb = _nb_of(pr, use_lanes)
    D = state.D
    n = pr.n_max
    d = pr.d

    # private rest edges: gather-form ΔRes
    def dres_rest(Da, pi, pj, pT):
        m = pi.shape[0]
        r, dh = Da.shape[-2:]
        Df = Da.reshape(n, r * dh)
        Di = Df[pi].reshape(m, r, dh)
        Dj = Df[pj].reshape(m, r, dh)
        return jnp.einsum("mra,mab->mrb", Di, pT, precision=_HI) - Dj

    res_rest = ref.res_rest + jax.vmap(dres_rest)(
        D, pr.priv_i[:, nb:], pr.priv_j[:, nb:], pr.priv_T[:, nb:]
    )

    # lane edges: shifted-dense ΔRes in lane layout
    res_lane = None
    if use_lanes:
        T_lane, _om_lane = lane_static
        offs = jnp.asarray(pr.band_offsets, jnp.int32)

        def dres_lane(Da, Tl):
            L = Tl.shape[0]
            r, dh = Da.shape[-2:]
            iota = jnp.arange(n, dtype=jnp.int32)
            up = jnp.clip(iota[None, :] + offs[:, None], 0, n - 1)
            Dj = Da[up.reshape(-1)].reshape(L, n, r, dh)
            # rows without an edge: T_lane = 0 and the garbage -D[i+delta]
            # lands in slots whose omega is 0 — but here the result is
            # STORED (not omega-gated), so zero it via the T_lane mask
            valid = (
                jnp.sum(jnp.abs(Tl), axis=(-2, -1), keepdims=True) > 0
            )
            return jnp.where(
                valid,
                jnp.einsum("nrb,lnbc->lnrc", Da, Tl, precision=_HI) - Dj,
                0.0,
            )

        res_lane = ref.res_lane + jax.vmap(dres_lane)(D, T_lane)

    # shared edges: both endpoint deltas
    def gather_nbr(D_blk):
        pub = jax.vmap(lambda Da, idx: Da[idx])(D_blk, pr.pub_idx)
        if axis_name is not None:
            pub = jax.lax.all_gather(pub, axis_name, axis=0, tiled=True)
        return pub[pr.shared_nbr_robot, pr.shared_nbr_slot]

    nbrD = gather_nbr(D)

    def dres_shared(Da, nd, sidx, sT, so):
        ms = sidx.shape[0]
        r, dh = Da.shape[-2:]
        Dl = Da.reshape(n, r * dh)[sidx].reshape(ms, r, dh)
        out_f = so[:, None, None]
        tailD = jnp.where(out_f, Dl, nd)
        headD = jnp.where(out_f, nd, Dl)
        return jnp.einsum("mra,mab->mrb", tailD, sT, precision=_HI) - headD

    res_shared = ref.res_shared + jax.vmap(dres_shared)(
        D, nbrD, pr.shared_idx, pr.shared_T, pr.shared_outgoing
    )

    M_ref = jax.vmap(
        lambda Y, M, E: _delta_K(Y, M, E)
    )(ref.X_ref[..., :d], ref.M_ref, D[..., :d])

    new_ref = CarryRef(
        X_ref=ref.X_ref + D, M_ref=M_ref,
        res_rest=res_rest, res_shared=res_shared, res_lane=res_lane,
    )
    new_state = DeltaState(
        D=jnp.zeros_like(D),
        DY=state.DY - D,  # exact: difference of small deltas
        DV=state.DV - D,
        ACC=state.ACC + D,
        gamma=state.gamma, it=state.it,
        prev_cost=state.prev_cost, do_restart=state.do_restart,
    )
    return new_ref, new_state


def _delta_round(problem_blk, cfg, axis_name,
                 ref_blk: CarryRef, state: DeltaState, qd_static,
                 lane_static, use_lanes: bool):
    pr = problem_blk
    nb = _nb_of(pr, use_lanes)
    om_p, om_s = _omegas(pr)
    # elastic membership (reference: PGOAgent.cpp:1173-1184, PoseGraph.cpp:
    # 418-430): shared edges whose neighbor is inactive drop from the
    # residual-form cost/gradient (the Hessian side is masked inside
    # _build_qd_static via the same _shared_activity_mask); inactive agents'
    # own blocks are frozen below.
    om_s = om_s * spmd_mod._shared_activity_mask(pr, cfg)[..., None]
    A = pr.priv_i.shape[0]
    offset = (jnp.asarray(0, jnp.int32) if axis_name is None
              else jax.lax.axis_index(axis_name).astype(jnp.int32) * A)
    active_blk = pr.robot_active[offset + jnp.arange(A, dtype=jnp.int32)]
    act = active_blk[:, None, None, None]
    act_f = active_blk.astype(state.D.dtype)
    a_priv = (pr.priv_i[:, nb:], pr.priv_j[:, nb:], pr.priv_T[:, nb:],
              om_p[:, nb:])
    a_shared = (pr.shared_idx, pr.shared_T, om_s, pr.shared_outgoing)
    a_ref = (ref_blk.res_rest, ref_blk.res_shared)
    offs = jnp.asarray(pr.band_offsets, jnp.int32) if use_lanes else None

    def gather_nbr(D_blk):
        pub = jax.vmap(lambda Da, idx: Da[idx])(D_blk, pr.pub_idx)
        if axis_name is not None:
            pub = jax.lax.all_gather(pub, axis_name, axis=0, tiled=True)
        return pub[pr.shared_nbr_robot, pr.shared_nbr_slot]

    def project_blk(W):
        return jax.vmap(delta_project_lifted)(ref_blk.X_ref, ref_blk.M_ref, W)

    if use_lanes:
        T_lane_blk, om_lane_blk = lane_static

        def one_agent(qd, Xr, Mr, rp, rs, pi, pj, pT, op, si, sT, os_, so,
                      Tl, oml, rl, D0, nd):
            return _delta_rtr_step(
                qd, Xr, Mr, (rp, rs), (pi, pj, pT, op), (si, sT, os_, so),
                D0, nd, cfg, lanes=((Tl, oml, rl), offs),
            )

        def run_agents(DY, nbrD):
            return jax.vmap(one_agent)(
                qd_static, ref_blk.X_ref, ref_blk.M_ref, *a_ref,
                *a_priv, *a_shared,
                T_lane_blk, om_lane_blk, ref_blk.res_lane, DY, nbrD,
            )
    else:

        def one_agent(qd, Xr, Mr, rp, rs, pi, pj, pT, op, si, sT, os_, so,
                      D0, nd):
            return _delta_rtr_step(
                qd, Xr, Mr, (rp, rs), (pi, pj, pT, op), (si, sT, os_, so),
                D0, nd, cfg,
            )

        def run_agents(DY, nbrD):
            return jax.vmap(one_agent)(
                qd_static, ref_blk.X_ref, ref_blk.M_ref, *a_ref,
                *a_priv, *a_shared, DY, nbrD,
            )

    def psum(x):
        return x if axis_name is None else jax.lax.psum(x, axis_name)

    if cfg.acceleration:
        N = pr.num_agents
        Nn = N if cfg.nesterov_n is None else cfg.nesterov_n
        # Restart = periodic (reference schedule, PGOAgent.cpp:880-885) OR
        # adaptive on objective increase (O'Donoghue & Candes function
        # scheme). The adaptive trigger is NOT optional here: Jacobi-parallel
        # 'all'-mode + Nesterov with periodic-only restarts provably can
        # diverge (measured: the f64 engine itself stalls at g~0.37 then
        # blows up on the 216-pose grid world; with the adaptive trigger it
        # converges to 2.4e-3 in 50 rounds). The signal is free: the round
        # objective is already computed.
        periodic = (state.it + 1) % cfg.restart_interval == 0
        restart = jnp.logical_or(periodic, state.do_restart)
        gamma = (1.0 + jnp.sqrt(1.0 + 4.0 * Nn**2 * state.gamma**2)) / (2.0 * Nn)
        alpha = 1.0 / (gamma * Nn)
        DY_acc = project_blk((1.0 - alpha) * state.D + alpha * state.DV)
        DY = jnp.where(restart, state.D, DY_acc)
        # inactive agents exchange their FROZEN delta (their last pose),
        # not an extrapolation of it
        DY = jnp.where(act, DY, state.D)
        nbrD = gather_nbr(DY)
        D_opt, gnorm_a, cost_a, egY = run_agents(DY, nbrD)
        D_opt = jnp.where(act, D_opt, state.D)
        DV = jnp.where(
            restart, D_opt, project_blk(state.DV + gamma * (D_opt - DY))
        )
        DV = jnp.where(act, DV, state.D)
        cost_now = psum(jnp.sum(cost_a * act_f))
        if cfg.restart_scheme == "exact":
            # O'Donoghue & Candes FUNCTION restart with the comparison
            # computed exactly. The objective is quadratic in the joint
            # iterate, so with the code's half-gradient eg(D) = QX + c
            # (affine in D, linear part Q·D):
            #   f(x') - f(x) = <eg(x) + eg(x'), x' - x>
            #                = <2·eg(Y) + Q·W, Δ>,  W = (x-Y) + (x'-Y)
            # where Q·W is ONE extra residual-form matvec evaluated with
            # ZEROED reference residuals (the delta machinery's gradient is
            # exactly Q·W when res_ref = 0). Every factor is small — the
            # signal resolves eps·|g|·|Δ|, far below the f32 cost
            # resolution eps·|f| that makes the plain comparison fire on
            # rounding noise once true per-round decreases drop under
            # ~eps·cost (city2d-100k tail: decrease ~2e-5/round vs cost
            # resolution ~4e-4 -> noise restarts kill the momentum).
            step = D_opt - state.D
            W = (state.D - DY) + (D_opt - DY)
            nbrW = gather_nbr(W)
            zp = jnp.zeros_like(ref_blk.res_rest)
            zs = jnp.zeros_like(ref_blk.res_shared)
            if use_lanes:
                zl = jnp.zeros_like(ref_blk.res_lane)

                def qmv_one(zp_a, zs_a, pi, pj, pT, op, si, sT, os_, so,
                            Tl, oml, zl_a, Wa, nw):
                    return _delta_cost_grad(
                        (zp_a, zs_a), (pi, pj, pT, op), (si, sT, os_, so),
                        Wa, nw, lanes=((Tl, oml, zl_a), offs),
                    )[1]

                QW = jax.vmap(qmv_one)(
                    zp, zs, *a_priv, *a_shared,
                    T_lane_blk, om_lane_blk, zl, W, nbrW,
                )
            else:

                def qmv_one(zp_a, zs_a, pi, pj, pT, op, si, sT, os_, so,
                            Wa, nw):
                    return _delta_cost_grad(
                        (zp_a, zs_a), (pi, pj, pT, op), (si, sT, os_, so),
                        Wa, nw,
                    )[1]

                QW = jax.vmap(qmv_one)(zp, zs, *a_priv, *a_shared, W, nbrW)
            df = psum(jnp.sum((2.0 * egY + QW) * step))
            do_restart_next = df > 0
        elif cfg.restart_scheme == "gradient":
            # O'Donoghue & Candes GRADIENT restart: fire when the step
            # opposes the gradient at the extrapolated point,
            # <grad f(Y), X_new - X_prev> > 0. Cancellation-free like
            # 'exact' but cheaper (no matvec); measured to under-restart on
            # small worlds (tinyGrid3D 212 vs 49 rounds) — kept as an
            # experimental knob, 'exact' is the production tail scheme.
            dec = psum(jnp.sum(egY * (D_opt - state.D) * act))
            do_restart_next = dec > 0
        else:
            # raw O'Donoghue-Candes function comparison; see
            # SPMDConfig.restart_cost_rtol for why the hair trigger stays
            do_restart_next = cost_now > state.prev_cost * (
                1 + cfg.restart_cost_rtol
            )
        new_state = DeltaState(
            D=D_opt,
            DY=jnp.where(act, jnp.where(restart, D_opt, DY), state.D),
            DV=DV,
            ACC=state.ACC,
            gamma=jnp.where(restart, 0.0, gamma).astype(state.gamma.dtype),
            it=state.it + 1,
            prev_cost=cost_now,
            do_restart=do_restart_next,
        )
    else:
        nbrD = gather_nbr(state.D)
        D_opt, gnorm_a, cost_a, _egY = run_agents(state.D, nbrD)
        D_opt = jnp.where(act, D_opt, state.D)
        new_state = DeltaState(
            D=D_opt, DY=D_opt, DV=D_opt, ACC=state.ACC,
            gamma=state.gamma, it=state.it + 1,
            prev_cost=psum(jnp.sum(cost_a * act_f)),
            do_restart=jnp.asarray(False),
        )

    # rel change directly from delta differences (X_ref cancels exactly)
    rel = jax.vmap(
        lambda a, b: jnp.max(
            jnp.linalg.norm(a[..., -1] - b[..., -1], axis=-1)
        )
    )(new_state.D, state.D)
    # inactive robots are excluded from every team metric (reference:
    # PGOAgent.cpp:860-861, PoseGraph.cpp:320-327); their shared edges are
    # already dropped via the activity-masked omegas
    metrics = spmd_mod.RoundMetrics(
        cost=psum(jnp.sum(cost_a * act_f)),
        gradnorm=jnp.sqrt(psum(jnp.sum(gnorm_a**2 * act_f))),
        max_rel_change=jax.lax.pmax(jnp.max(rel), axis_name)
        if axis_name is not None else jnp.max(rel),
    )
    return new_state, metrics


def make_delta_run_fn(problem: spmd_mod.SPMDProblem, cfg: spmd_mod.SPMDConfig,
                      mesh: Optional[Mesh] = None, reanchor_every: int = 0,
                      use_lanes: Optional[bool] = None):
    """Fused run-to-tolerance driver for the delta engine: all rounds as one
    XLA while_loop (like spmd.make_run_fn), with the anchor folded ON DEVICE
    every `reanchor_every` rounds (0 = never) — no host round-trips inside a
    call. Returns run(ref, state, max_rounds, tol) ->
    (state, ref', metrics, rounds); pass ref' to the next call (the anchor
    advanced on device; the true iterate is host_anchor + state.ACC +
    state.D)."""
    N = problem.num_agents
    if use_lanes is None:
        use_lanes = _lanes_usable(problem)

    def make_loop(axis_name, pr_blk, qd_static, lane_static):
        def cond(c):
            _state, _ref, metrics, rounds, max_rounds, tol = c
            return jnp.logical_and(
                rounds < max_rounds, metrics.gradnorm >= tol
            )

        def body(c):
            state, ref, _m, rounds, max_rounds, tol = c
            new_state, metrics = _delta_round(
                pr_blk, cfg, axis_name, ref, state, qd_static,
                lane_static, use_lanes,
            )
            if reanchor_every > 0:
                ref, new_state = jax.lax.cond(
                    new_state.it % reanchor_every == 0,
                    lambda r, s: _fold_anchor(
                        pr_blk, axis_name, r, s, lane_static, use_lanes
                    ),
                    lambda r, s: (r, s),
                    ref, new_state,
                )
            return (new_state, ref, metrics, rounds + 1, max_rounds, tol)

        return cond, body

    def init_metrics(dtype):
        return spmd_mod.RoundMetrics(
            cost=jnp.asarray(jnp.inf, dtype),
            gradnorm=jnp.asarray(jnp.inf, dtype),
            max_rel_change=jnp.asarray(jnp.inf, dtype),
        )

    def body_run(pr_blk, ref_blk, state_blk, max_rounds, tol, axis_name):
        om_p, _ = _omegas(pr_blk)
        qd_static = spmd_mod._build_qd_static(pr_blk, cfg)
        lane_static = _build_lane_static(pr_blk, om_p, use_lanes)
        carry_ref = _make_carry_ref(pr_blk, ref_blk, om_p, use_lanes)
        cond, body = make_loop(axis_name, pr_blk, qd_static, lane_static)
        state, carry_ref, metrics, rounds, *_ = jax.lax.while_loop(
            cond, body,
            (state_blk, carry_ref, init_metrics(state_blk.D.dtype),
             jnp.asarray(0, jnp.int32), jnp.asarray(max_rounds, jnp.int32),
             jnp.asarray(tol, state_blk.D.dtype)),
        )
        ref_out = _carry_to_delta_ref(pr_blk, carry_ref, use_lanes)
        return state, ref_out, metrics, rounds

    if mesh is None:
        @jax.jit
        def _run(pr, ref, state, max_rounds, tol):
            return body_run(pr, ref, state, max_rounds, tol, None)

        def run(ref, state, max_rounds, tol, problem=problem):
            return _run(problem, ref, state, max_rounds, tol)

        return run

    n_dev = mesh.devices.size
    assert N % n_dev == 0
    blk = P("agents")
    rep = P()

    def sharded_run(pr_blk, ref_blk, state_blk, max_rounds, tol):
        return body_run(pr_blk, ref_blk, state_blk, max_rounds, tol,
                        "agents")

    problem_specs = spmd_mod.SPMDProblem(
        num_agents=N, n_max=problem.n_max, d=problem.d, r=problem.r,
        num_band=problem.num_band, band_offsets=problem.band_offsets,
        **{f: (rep if f in spmd_mod._REPLICATED_FIELDS else blk)
           for f in spmd_mod._DATA_FIELDS},
    )
    ref_specs = DeltaRef(X_ref=blk, res_ref_priv=blk, res_ref_shared=blk,
                         M_ref=blk)
    state_specs = DeltaState(D=blk, DY=blk, DV=blk, ACC=blk, gamma=rep,
                             it=rep, prev_cost=rep, do_restart=rep)
    fn = jax.shard_map(
        sharded_run, mesh=mesh,
        in_specs=(problem_specs, ref_specs, state_specs, rep, rep),
        out_specs=(state_specs, ref_specs,
                   spmd_mod.RoundMetrics(rep, rep, rep), rep),
        check_vma=False,
    )
    blk_sh = NamedSharding(mesh, blk)

    @jax.jit
    def _run(pr, ref, state, max_rounds, tol):
        return fn(pr, ref, state, max_rounds, tol)

    def run(ref, state, max_rounds, tol, problem=problem):
        pr_dev = spmd_mod._device_put_problem(problem, mesh)
        ref_dev = jax.tree.map(lambda x: jax.device_put(x, blk_sh), ref)
        return _run(pr_dev, ref_dev, state, max_rounds, tol)

    return run


def host_certify(problem: spmd_mod.SPMDProblem, X64: np.ndarray):
    """Pure-numpy f64 evaluation of (global objective, global Riemannian
    gradient norm) at a stacked iterate (N, n_max, r, dh) — the honest
    certification step, independent of any device or reduced precision.

    Shared edges appear once in each endpoint's agent block (flagged
    outgoing/incoming); each copy contributes the gradient of its LOCAL
    side only, so the union covers the global gradient exactly — the same
    attribution the SPMD metrics use (validated against the central
    evaluation in tests/test_spmd.py)."""
    X = np.asarray(X64, np.float64)
    N, n_max, r, dh = X.shape
    d = dh - 1

    def omega(kappa, tau, weight):
        om = np.empty(kappa.shape + (dh,))
        om[..., :d] = (weight * kappa)[..., None]
        om[..., d] = weight * tau
        return om

    om_p = omega(np.asarray(problem.priv_kappa, np.float64),
                 np.asarray(problem.priv_tau, np.float64),
                 np.asarray(problem.priv_weight, np.float64))
    om_s = omega(np.asarray(problem.shared_kappa, np.float64),
                 np.asarray(problem.shared_tau, np.float64),
                 np.asarray(problem.shared_weight, np.float64))

    T = np.asarray(problem.priv_T, np.float64)
    i_idx = np.asarray(problem.priv_i)
    j_idx = np.asarray(problem.priv_j)
    Xi = np.take_along_axis(X, i_idx[:, :, None, None], axis=1)
    Xj = np.take_along_axis(X, j_idx[:, :, None, None], axis=1)
    Res = np.einsum("qmra,qmab->qmrb", Xi, T, optimize=True) - Xj
    Rw = Res * om_p[:, :, None, :]
    cost = np.sum(Res * Rw)
    G = np.zeros((N, n_max, r, dh))
    gi = np.einsum("qmrb,qmab->qmra", Rw, T, optimize=True)
    for a in range(N):
        np.add.at(G[a], i_idx[a], gi[a])
        np.add.at(G[a], j_idx[a], -Rw[a])

    pub = np.take_along_axis(
        X, np.asarray(problem.pub_idx)[:, :, None, None], axis=1
    )
    nbr = pub[np.asarray(problem.shared_nbr_robot),
              np.asarray(problem.shared_nbr_slot)]
    Xl = np.take_along_axis(
        X, np.asarray(problem.shared_idx)[:, :, None, None], axis=1
    )
    Ts = np.asarray(problem.shared_T, np.float64)
    out = np.asarray(problem.shared_outgoing)[:, :, None, None]
    tail = np.where(out, Xl, nbr)
    head = np.where(out, nbr, Xl)
    Res_s = np.einsum("qmra,qmab->qmrb", tail, Ts, optimize=True) - head
    Rw_s = Res_s * om_s[:, :, None, :]
    cost += np.sum(Res_s * Rw_s * out)  # attribute to the outgoing side
    contrib = np.where(
        out, np.einsum("qmrb,qmab->qmra", Rw_s, Ts, optimize=True), -Rw_s
    )
    sidx = np.asarray(problem.shared_idx)
    for a in range(N):
        np.add.at(G[a], sidx[a], contrib[a])

    # Riemannian projection: rotation block minus its normal component
    Y = X[..., :d]
    Gr = G[..., :d]
    YtG = np.einsum("qnra,qnrb->qnab", Y, Gr, optimize=True)
    sym = 0.5 * (YtG + np.swapaxes(YtG, -1, -2))
    Gr_t = Gr - np.einsum("qnra,qnab->qnrb", Y, sym, optimize=True)
    gradnorm = float(np.sqrt(np.sum(Gr_t**2) + np.sum(G[..., d] ** 2)))
    return float(cost), gradnorm


def run_delta_certified(
    problem: spmd_mod.SPMDProblem,
    X0_64: np.ndarray,
    cfg: spmd_mod.SPMDConfig,
    tol: float,
    mesh: Optional[Mesh] = None,
    chunk: int = 50,
    max_rounds: int = 2000,
    verbose: bool = False,
    reanchor_every: int = 25,
):
    """Host driver for the delta engine: device-resident launches of up to
    `chunk` rounds with ON-DEVICE anchor folds every `reanchor_every` rounds
    — between launches NOTHING moves host<->device except the round metrics
    that feed the progress trace and the stop test.

    Returns (X_final64, info). X_final64 = X_base + ACC + D, assembled in
    f64 on the host; callers certify by evaluating the f64 global Riemannian
    gradient norm there (host_certify)."""
    X_base = np.array(X0_64, np.float64)  # (N, n_max, r, dh) stacked
    run = make_delta_run_fn(problem, cfg, mesh, reanchor_every=reanchor_every)
    ref = build_delta_ref(problem, X_base)
    state = initial_delta_state(ref)
    total = 0
    gn = float("inf")
    trace = []
    while total < max_rounds and gn >= tol:
        state, ref, metrics, rounds = run(
            ref, state, min(chunk, max_rounds - total), tol
        )
        total += int(rounds)
        gn = float(metrics.gradnorm)
        cost = float(metrics.cost)
        trace.append({"rounds": total, "gradnorm": gn, "cost": cost})
        if verbose:
            print(f"  delta round {total}: gradnorm={gn:.6f} "
                  f"cost={cost:.2f}", flush=True)
    info = {"rounds": total, "trace": trace, "device_gradnorm": gn}
    # the ~eps32*|ACC| rounding of an f32 add could flip a marginal host-f64
    # certification, so ACC and D come back separately and sum in f64
    X_final = (X_base + np.asarray(state.ACC, np.float64)
               + np.asarray(state.D, np.float64))
    return X_final, info


# ---------------------------------------------------------------------------
# GNC-TLS + elastic membership on the delta engine (robust outlier rejection
# at certified scale; reference semantics PGOAgent.cpp:997-1142)
# ---------------------------------------------------------------------------

@jax.jit
def delta_residuals_sq(problem: spmd_mod.SPMDProblem, ref: DeltaRef,
                       D: jax.Array):
    """Per-edge squared measurement residuals at (anchor + D), entirely in
    residual form: Res = Res_ref + ΔRes(D) with ΔRes edge-local in the
    deltas — no pose values are ever materialized, so the evaluation is as
    cancellation-free as the engine's cost/gradient. Homogeneous residual
    columns split as Res[..., :d] = Yi·R − Yj (rotation) and
    Res[..., d] = Yi·t + ti − tj (translation); the squared residual is the
    reference's kappa·||rot||² + tau·||trans||² (PGOAgent.cpp:1062-1101).
    Returns ((N, mp), (N, ms)); padded edges report 0 (kappa = tau = 0)."""
    pr = problem
    d = pr.d
    n = pr.n_max
    _N, _n, r, dh = D.shape

    def dres_priv(Da, pi, pj, pT):
        m = pi.shape[0]
        Df = Da.reshape(n, r * dh)
        Di = Df[pi].reshape(m, r, dh)
        Dj = Df[pj].reshape(m, r, dh)
        return jnp.einsum("mra,mab->mrb", Di, pT, precision=_HI) - Dj

    Res_p = ref.res_ref_priv + jax.vmap(dres_priv)(
        D, pr.priv_i, pr.priv_j, pr.priv_T
    )
    r_sq_priv = (
        pr.priv_kappa * jnp.sum(Res_p[..., :d] ** 2, axis=(-2, -1))
        + pr.priv_tau * jnp.sum(Res_p[..., d] ** 2, axis=-1)
    )

    pub = jax.vmap(lambda Da, idx: Da[idx])(D, pr.pub_idx)
    nbrD = pub[pr.shared_nbr_robot, pr.shared_nbr_slot]

    def dres_shared(Da, nd, sidx, sT, so):
        ms = sidx.shape[0]
        Dl = Da.reshape(n, r * dh)[sidx].reshape(ms, r, dh)
        out_f = so[:, None, None]
        tailD = jnp.where(out_f, Dl, nd)
        headD = jnp.where(out_f, nd, Dl)
        return jnp.einsum("mra,mab->mrb", tailD, sT, precision=_HI) - headD

    Res_s = ref.res_ref_shared + jax.vmap(dres_shared)(
        D, nbrD, pr.shared_idx, pr.shared_T, pr.shared_outgoing
    )
    r_sq_shared = (
        pr.shared_kappa * jnp.sum(Res_s[..., :d] ** 2, axis=(-2, -1))
        + pr.shared_tau * jnp.sum(Res_s[..., d] ** 2, axis=-1)
    )
    return r_sq_priv, r_sq_shared


@jax.jit
def delta_gnc_reweight(problem: spmd_mod.SPMDProblem, ref: DeltaRef,
                       D: jax.Array, barc_sq, mu) -> spmd_mod.SPMDProblem:
    """GNC-TLS measurement reweighting for the delta engine — residual-form
    residuals + the shared weight-update rule (fixed-weight odometry
    untouched, edges to inactive neighbors keep their last weight; reference
    PGOAgent.cpp:1015-1016, 1062-1142). The reweighted problem feeds the
    next run chunk as a runtime argument: same shapes, no recompile, and the
    anchor (residuals are weight-independent) stays valid."""
    r_sq_p, r_sq_s = delta_residuals_sq(problem, ref, D)
    return spmd_mod._apply_gnc_weights(problem, r_sq_p, r_sq_s, barc_sq, mu)


def run_delta_gnc(
    problem: spmd_mod.SPMDProblem,
    X0_64: np.ndarray,
    cfg: spmd_mod.SPMDConfig,
    barc: float = 5.0,
    init_mu: Optional[float] = None,
    mu_step: float = 1.4,
    num_weight_updates: int = 10,
    inner_rounds: int = 30,
    mesh: Optional[Mesh] = None,
    reanchor_every: int = 25,
    verbose: bool = False,
):
    """Distributed GNC-TLS at certified (delta-engine) quality: alternate
    fused delta-RBCD chunks with team-wide weight updates and a growing mu
    (the reference's distributed robust schedule, PGOAgent.cpp:997-1142,
    mirrored from spmd.run_rbcd_gnc onto the anchored engine).

    init_mu=None uses the adaptive initialization of the reference's batch
    GNC (DPGO_solver.cpp:356-358): mu0 = barc²/(2·max r² − barc²) at the
    first converged iterate. The robot_active mask composes: inactive
    agents' blocks stay frozen through both the inner rounds and the weight
    updates.

    Returns (problem, state, ref, X64, history): the reweighted problem (its
    weights identify the outliers), the final delta state/ref (resume or
    certify from them — e.g. run_delta_certified with the reweighted
    problem), the f64 iterate, and the per-phase history."""
    barc_sq = barc * barc
    run = make_delta_run_fn(problem, cfg, mesh, reanchor_every=reanchor_every)
    X_base = np.array(X0_64, np.float64)
    ref = build_delta_ref(problem, X_base)
    state = initial_delta_state(ref)
    mu = init_mu
    history = []
    for _k in range(num_weight_updates):
        state, ref, metrics, rounds = run(
            ref, state, inner_rounds, 0.0, problem=problem
        )
        if mu is None:
            r_sq_p, r_sq_s = delta_residuals_sq(problem, ref, state.D)
            r_max = float(jnp.maximum(jnp.max(r_sq_p), jnp.max(r_sq_s)))
            mu = barc_sq / max(2.0 * r_max - barc_sq, barc_sq * 1e-3)
        problem = delta_gnc_reweight(problem, ref, state.D, barc_sq, mu)
        mu *= mu_step
        history.append(
            {"rounds": int(rounds), "cost": float(metrics.cost), "mu": mu}
        )
        if verbose:
            print(f"  delta-gnc phase {_k}: rounds={int(rounds)} "
                  f"cost={float(metrics.cost):.4f} mu={mu:.4g}", flush=True)
    X = (X_base + np.asarray(state.ACC, np.float64)
         + np.asarray(state.D, np.float64))
    return problem, state, ref, X, history
