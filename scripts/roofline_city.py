#!/usr/bin/env python
"""Per-op roofline evidence for the city2d-100k certified round: does the
round sit near the device's achievable bound for this block size?

The city world's blocks are tiny — r=3, dh=3, a 36-byte f32 row per pose —
and 34% of edges sit at non-laneable offsets, so the delta round's
irreducible work is INDEXED movement of 36-byte rows (gather by edge index,
scatter-add back), not FLOPs. This script measures, on the live backend:

  1. the fused production round at the certified schedule (tcg cap 3),
     warm, from a mid-run state — the number the headline pays;
  2. the bare primitives at the SAME shapes/indices: stream copy,
     edge-index gather, segment scatter-add, the dense band-lane einsum,
     and the closed-form 2x2 polar projection;
  3. a data-movement account: bytes each round must touch through the
     gather engine, and the lower bound implied by the measured bare
     gather/scatter speed.

The question it answers: is production_round_ms close to
(bytes_round / measured_indexed_bandwidth) + lane/projection terms, i.e. is
the round gather-bound at speeds the device actually achieves on this
access pattern? Reference workload shape: PoseGraph.cpp:381-491 (the operator),
MultiRobotExample.cpp:170-207 (the round).
"""

import os
import sys
import time
import dataclasses as dc

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import numpy as np
import jax
import jax.numpy as jnp

from dpgo_tpu.datasets import synthesize_city2d
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel import delta as delta_mod
from dpgo_tpu.parallel import spmd

NUM_POSES = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
AGENTS = 10
TCG = int(os.environ.get("DPGO_SCALE_TCG_ITERS", "3"))
seed = 1

edges, n, _ = synthesize_city2d(NUM_POSES, seed=seed)
meas = edges.to_measurements()
problem, ranges = spmd.build_spmd_problem(
    meas, n, num_agents=AGENTS, r=3, dtype=jnp.float32
)
from dpgo_tpu.solvers import chordal as chordal_mod

T = np.asarray(chordal_mod.chordal_initialization_arrays(edges, n=n))
Y_lift = np.asarray(lifted.fixed_stiefel_variable(2, 3))
X0 = np.einsum("rd,nde->nre", Y_lift, T)
state = spmd.initial_state(problem, X0, ranges)

cfg = spmd.SPMDConfig(
    mode="all", acceleration=True, rtr_iterations=1,
    rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(AGENTS)),
    adaptive_restart=True, restart_scheme="exact",
    restart_interval=1_000_000, nesterov_n=5,
    rtr_tcg_iterations=TCG,
)


def timed(tag, fn, *args, reps=3):
    def sync(o):
        return float(jnp.sum(jax.tree.leaves(o)[0]))

    sync(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    print(f"{tag}: {best * 1000:.2f} ms", flush=True)
    return best


# --- 1) production fused round, warm, MID-RUN state (the tail the
#        certified wall lives in: rounds 100-120 of the production run)
X64 = np.asarray(state.X, np.float64)
ref = delta_mod.build_delta_ref(problem, X64)
dstate = delta_mod.initial_delta_state(ref)
run = delta_mod.make_delta_run_fn(problem, cfg, mesh=None,
                                  reanchor_every=25)
dstate, ref, _m, _r = run(ref, dstate, 100, 1e-12)
jax.block_until_ready(dstate.D)
R = 20
t_round = timed(f"production fused round x{R} (tcg={TCG}, warm, mid-run)",
                lambda s: run(ref, s, R, 1e-12)[0].D, dstate, reps=2) / R
print(f"  -> {t_round * 1000:.1f} ms/round", flush=True)

# --- 2) bare primitives at the SAME shapes -------------------------------
# Standalone one-shot calls are dispatch-floored, so each primitive runs
# REPS times inside ONE device execution with a serial data dependency (the
# output feeds the next iteration — XLA cannot hoist it out of the loop);
# per-rep time = execution_time / REPS with the dispatch amortized away.
REPS = 100
pr = jax.tree.map(jnp.asarray, problem)
A, mp = pr.priv_i.shape
D = dstate.D  # (A, n_max, r, dh)
row_bytes = D.shape[-1] * D.shape[-2] * 4  # 36 B
flat = D.reshape(A, problem.n_max, -1)
i_idx = pr.priv_i
j_idx = pr.priv_j


def reps(tag, step, x0, bytes_per_rep):
    f = jax.jit(
        lambda x: jax.lax.fori_loop(0, REPS, lambda i, y: step(y), x)
    )
    t = timed(tag + f" x{REPS}", f, x0) / REPS
    print(f"  -> {t * 1000:.3f} ms/rep, "
          f"{bytes_per_rep / t / 1e9:.0f} GB/s", flush=True)
    return t


stream = reps("stream copy (A,n,9) f32", lambda x: x * 1.000001, flat,
              2 * flat.size * 4)


def gather_step(x):
    vals = jax.vmap(lambda fa, ia: fa[ia])(x, i_idx)
    # fold the gathered values back so the next rep depends on this one
    return x * 1.000001 + 1e-30 * jax.vmap(
        lambda v, ia: jnp.zeros_like(x[0]).at[ia].add(v)
    )(vals, j_idx)


g_bytes = A * mp * row_bytes * 2  # one gather read + one scatter-add write
g_t = reps(f"gather+scatter-add {A}x{mp} rows of {row_bytes} B",
           gather_step, flat, g_bytes)

T_lane0 = jnp.zeros((A, problem.n_max, 3, 3), jnp.float32)
lane_t = reps(
    "dense lane einsum (A,n,3,3)x(A,n,3,3)",
    lambda Dv: jnp.einsum("anrb,anbc->anrc", Dv, T_lane0) + Dv * 1.000001,
    D, 3 * D.size * 4)

proj_t = reps(
    "delta polar projection (closed-form 2x2)",
    lambda W: jax.vmap(delta_mod.delta_project_lifted)(
        ref.X_ref, ref.M_ref, W),
    D, 2 * D.size * 4)

# --- 3) data-movement account --------------------------------------------
m_real = int(np.sum(np.asarray(problem.priv_weight) > 0))
ms_real = int(np.sum(np.asarray(problem.shared_kappa) > 0))
lane_cover = float(np.mean(
    np.isin(np.asarray(problem.priv_j) - np.asarray(problem.priv_i),
            np.asarray(problem.band_offsets))
    [np.asarray(problem.priv_weight) > 0]))
m_gather = int(m_real * (1 - lane_cover)) + ms_real
# Per accelerated round (delta._delta_round + _delta_rtr_step at tcg cap c):
#   2 cost_grad (at Y and at X') + 1 exact-restart QW matvec + c Hessian
#   matvecs — each pays the gather+scatter pattern on the non-laned edges
#   (padded to mp) plus one lane einsum + stream pass; (c+1) preconditioner
#   applies, 3 projections, 2 neighbor gathers (small) are stream terms.
passes = 3 + TCG
# the engine processes the PADDED gather arrays (mp per agent), so the
# achievable bound uses the same padded volume the kernels actually move.
# Each pass touches BOTH endpoints of every edge: Df[pi] and Df[pj] reads,
# G.at[pi].add and G.at[pj].add writes (_delta_cost_grad; q_matvec's gather
# path is the same shape) — the measured primitive does one gather + one
# scatter per rep, so a pass costs 2x the primitive.
t_indexed = passes * 2 * g_t
t_stream = passes * lane_t + (TCG + 1 + 3) * stream + 3 * proj_t
bound = t_indexed + t_stream
print("\n--- account ---")
print(f"real edges: {m_real + ms_real} ({m_gather} real on the gather "
      f"path; padded {A}x{mp})")
print(f"matvec-like passes/round: {passes} (2 cost_grad + QW + {TCG} "
      f"hessvec)")
print(f"indexed term: {passes} x 2 x {g_t * 1000:.2f} ms = "
      f"{t_indexed * 1000:.1f} ms (2 gathers + 2 scatters per pass)")
print(f"stream terms (lanes {passes}x{lane_t * 1000:.2f} + precond/nbr "
      f"{TCG + 4}x{stream * 1000:.2f} + proj 3x{proj_t * 1000:.2f}): "
      f"{t_stream * 1000:.1f} ms")
print(f"sum-of-measured-primitives bound: {bound * 1000:.1f} ms/round; "
      f"production fused round: {t_round * 1000:.1f} ms/round; "
      f"ratio {t_round / bound:.2f}x")
flops = passes * (m_real + ms_real) * 2 * 3 * 9 * 2
print(f"arithmetic: {flops / 1e9:.2f} GFLOP/round")
