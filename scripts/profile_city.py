#!/usr/bin/env python
"""Round-5 city2d-100k round decomposition (VERDICT r4 #2): measure exactly
where the ~0.5 s/round wall goes in the PRODUCTION certified configuration
(delta engine, tcg=20, restart_scheme='exact'), op by op, so the attack is
profile-driven rather than guessed. Every timing materializes a scalar to
the host.

Usage: python scripts/profile_city.py [num_poses] [reps]
"""

import dataclasses as dc
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import numpy as np

import jax
import jax.numpy as jnp

from dpgo_tpu.datasets import synthesize_city2d
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel import delta as delta_mod
from dpgo_tpu.parallel import spmd

num_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
REPS = int(sys.argv[2]) if len(sys.argv) > 2 else 3
num_agents = 10
seed = 1
d, r = 2, 3

edges, n, T_true = synthesize_city2d(num_poses, seed=seed)
meas = edges.to_measurements()
problem, ranges = spmd.build_spmd_problem(
    meas, n, num_agents=num_agents, r=r, dtype=jnp.float32
)
print(f"edges={edges.m} band_offsets={problem.band_offsets} "
      f"num_band={problem.num_band} mp_max={problem.priv_i.shape[1]} "
      f"ms_max={problem.shared_idx.shape[1]}", flush=True)

X0 = np.einsum(
    "rd,nde->nre", np.asarray(lifted.fixed_stiefel_variable(d, r)),
    np.broadcast_to(np.eye(d, d + 1), (n, d, d + 1)),
)
state = spmd.initial_state(problem, X0, ranges)

# the production certified configuration (scripts/scale_bench.py)
cfg = spmd.SPMDConfig(
    mode="all", acceleration=True, rtr_iterations=1,
    rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)),
    adaptive_restart=True, rtr_tcg_iterations=20,
    restart_interval=1_000_000, nesterov_n=5,
    restart_scheme="exact", rtr_residual_control=True,
    rtr_tcg_precision="high",
)


def timed(tag, fn, *args):
    def sync(o):
        return float(jnp.sum(jax.tree.leaves(o)[0]))

    out = fn(*args)
    sync(out)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        sync(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{tag}: {best*1000:.1f} ms", flush=True)
    return out


X64 = np.asarray(state.X, np.float64)
ref = delta_mod.build_delta_ref(problem, X64)
dstate = delta_mod.initial_delta_state(ref)

# ---- full fused rounds, production config, two chunk sizes --------------
R = 20
run_delta = delta_mod.make_delta_run_fn(problem, cfg, mesh=None,
                                        reanchor_every=25)
timed(f"delta[exact] x{R} (per-round below)",
      lambda s: run_delta(ref, s, R, 1e-12)[0].D, dstate)
t0 = time.perf_counter()
run_delta(ref, dstate, R, 1e-12)[0].D.block_until_ready()
out = run_delta(ref, dstate, R, 1e-12)
float(jnp.sum(out[0].D))
dt = time.perf_counter() - t0
print(f"  -> {dt/2/R*1000:.1f} ms/round (incl dispatch/2)", flush=True)

cfg_cost = dc.replace(cfg, restart_scheme="cost")
run_cost = delta_mod.make_delta_run_fn(problem, cfg_cost, mesh=None,
                                       reanchor_every=25)
timed(f"delta[cost] x{R}", lambda s: run_cost(ref, s, R, 1e-12)[0].D, dstate)

cfg_noacc = dc.replace(cfg, acceleration=False)
run_na = delta_mod.make_delta_run_fn(problem, cfg_noacc, mesh=None,
                                     reanchor_every=25)
timed(f"delta[no-accel] x{R}", lambda s: run_na(ref, s, R, 1e-12)[0].D, dstate)

cfg_t5 = dc.replace(cfg, rtr_tcg_iterations=5)
run_t5 = delta_mod.make_delta_run_fn(problem, cfg_t5, mesh=None,
                                     reanchor_every=25)
timed(f"delta[tcg=5] x{R}", lambda s: run_t5(ref, s, R, 1e-12)[0].D, dstate)

# ---- sub-ops -------------------------------------------------------------
pr_blk = jax.tree.map(jnp.asarray, problem)
use_lanes = delta_mod._lanes_usable(problem)
om_p, om_s = delta_mod._omegas(pr_blk)
qd_static = spmd._build_qd_static(pr_blk, cfg)
lane_static = delta_mod._build_lane_static(pr_blk, om_p, use_lanes)
carry = delta_mod._make_carry_ref(pr_blk, ref, om_p, use_lanes)
nb = delta_mod._nb_of(pr_blk, use_lanes)
a_priv = (pr_blk.priv_i[:, nb:], pr_blk.priv_j[:, nb:],
          pr_blk.priv_T[:, nb:], om_p[:, nb:])
a_shared = (pr_blk.shared_idx, pr_blk.shared_T, om_s,
            pr_blk.shared_outgoing)
offs = jnp.asarray(pr_blk.band_offsets, jnp.int32)
D = dstate.D
pub = jax.vmap(lambda Da, idx: Da[idx])(D, pr_blk.pub_idx)
nbrD = pub[pr_blk.shared_nbr_robot, pr_blk.shared_nbr_slot]
print(f"use_lanes={use_lanes} rest_edges/agent={a_priv[0].shape[1]} "
      f"band/agent={nb}", flush=True)

T_lane_blk, om_lane_blk = lane_static


@jax.jit
def cost_grad_full(D, nbrD):
    def one(pi, pj, pT, op, si, sT, os_, so, rp, rs, Tl, oml, rl, Da, nd):
        return delta_mod._delta_cost_grad(
            (rp, rs), (pi, pj, pT, op), (si, sT, os_, so), Da, nd,
            lanes=((Tl, oml, rl), offs),
        )
    return jax.vmap(one)(*a_priv, *a_shared, carry.res_rest,
                         carry.res_shared, T_lane_blk, om_lane_blk,
                         carry.res_lane, D, nbrD)


timed("cost_grad full (lane+rest+shared)", cost_grad_full, D, nbrD)


@jax.jit
def cost_grad_lane_only(D):
    def one(Tl, oml, rl, Da):
        return delta_mod._lane_cost_grad((Tl, oml, rl), offs, Da)
    return jax.vmap(one)(T_lane_blk, om_lane_blk, carry.res_lane, D)


timed("cost_grad lane part only", cost_grad_lane_only, D)


@jax.jit
def cost_grad_rest_only(D, nbrD):
    def one(pi, pj, pT, op, si, sT, os_, so, rp, rs, Da, nd):
        return delta_mod._delta_cost_grad(
            (rp, rs), (pi, pj, pT, op), (si, sT, os_, so), Da, nd,
        )
    return jax.vmap(one)(*a_priv, *a_shared, carry.res_rest,
                         carry.res_shared, D, nbrD)


timed("cost_grad rest+shared (scatter path)", cost_grad_rest_only, D, nbrD)


@jax.jit
def project_all(W):
    return jax.vmap(delta_mod.delta_project_lifted)(ref.X_ref, ref.M_ref, W)


timed("project (delta polar, vmapped)", project_all, D)


@jax.jit
def gather_all(D):
    pub = jax.vmap(lambda Da, idx: Da[idx])(D, pr_blk.pub_idx)
    return pub[pr_blk.shared_nbr_robot, pr_blk.shared_nbr_slot]


timed("gather_nbr", gather_all, D)


@jax.jit
def tcg_all(D):
    X = ref.X_ref + D

    def one(qd, Xa, Da):
        from dpgo_tpu.solvers import rtr as rtr_mod

        from dpgo_tpu import quadratic as q
        eg = jnp.ones_like(Da)
        g = lifted.proj_tangent(Xa, eg)
        S = q.hess_correction(Xa, eg)
        return rtr_mod._tcg(qd, Xa, S, g, jnp.asarray(1.0, Da.dtype),
                            cfg.rtr_tcg_iterations,
                            precision=jax.lax.Precision.HIGH).eta

    return jax.vmap(one)(qd_static, X, D)


timed(f"tcg {cfg.rtr_tcg_iterations}-iter (vmapped)", tcg_all, D)

# the 'exact' restart's QW matvec (zeroed reference residuals)
zp = jnp.zeros_like(carry.res_rest)
zs = jnp.zeros_like(carry.res_shared)
zl = jnp.zeros_like(carry.res_lane)


@jax.jit
def qw_matvec(W, nbrW):
    def one(pi, pj, pT, op, si, sT, os_, so, zp_a, zs_a, Tl, oml, zl_a,
            Wa, nw):
        return delta_mod._delta_cost_grad(
            (zp_a, zs_a), (pi, pj, pT, op), (si, sT, os_, so), Wa, nw,
            lanes=((Tl, oml, zl_a), offs),
        )[1]
    return jax.vmap(one)(*a_priv, *a_shared, zp, zs, T_lane_blk,
                         om_lane_blk, zl, D, nbrD)


timed("QW matvec ('exact' restart extra)", qw_matvec, D, nbrD)

# flat vs vmapped scatter-add at this problem's rest-edge count
A, m_rest = np.asarray(a_priv[0]).shape
n_max = D.shape[1]
flat_i = (np.arange(A)[:, None] * n_max + np.asarray(a_priv[0])).reshape(-1)
flat_j = (np.arange(A)[:, None] * n_max + np.asarray(a_priv[1])).reshape(-1)
contrib = jnp.asarray(
    np.random.default_rng(0).standard_normal((A * m_rest, r * (d + 1))),
    jnp.float32,
)
pi_dev = jnp.asarray(flat_i)
pj_dev = jnp.asarray(flat_j)


@jax.jit
def scatter_two(c):
    out = jnp.zeros((A * n_max, r * (d + 1)), jnp.float32)
    out = out.at[pi_dev].add(c)
    out = out.at[pj_dev].add(-c)
    return out


timed("XLA scatter x2 (flat)", scatter_two, contrib)


# vmapped (per-agent) scatter — what _delta_cost_grad actually does today
pi_a = jnp.asarray(np.asarray(a_priv[0]))
pj_a = jnp.asarray(np.asarray(a_priv[1]))
contrib_a = contrib.reshape(A, m_rest, r * (d + 1))


@jax.jit
def scatter_vmapped(c):
    def one(pi, pj, ca):
        out = jnp.zeros((n_max, r * (d + 1)), jnp.float32)
        out = out.at[pi].add(ca)
        out = out.at[pj].add(-ca)
        return out
    return jax.vmap(one)(pi_a, pj_a, c)


timed("XLA scatter x2 (vmapped per-agent)", scatter_vmapped, contrib_a)
