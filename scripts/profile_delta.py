#!/usr/bin/env python
"""Profile the certified-pipeline pieces at scale on the current backend:
plain SPMD rounds vs delta rounds, plus delta sub-ops."""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import dataclasses as dc

import numpy as np

import jax
import jax.numpy as jnp

from dpgo_tpu.datasets import synthesize_city2d, synthesize_grid3d
from dpgo_tpu.ops import lifted
from dpgo_tpu.parallel import delta as delta_mod
from dpgo_tpu.parallel import spmd

num_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
num_agents = 10
seed = 1
world = os.environ.get("DPGO_SCALE_WORLD", "grid3d")
d = 3 if world == "grid3d" else 2
r = int(os.environ.get("DPGO_SCALE_R", "5" if d == 3 else "3"))

if world == "grid3d":
    edges, n, T_true = synthesize_grid3d(num_poses, seed=seed)
else:
    edges, n, T_true = synthesize_city2d(num_poses, seed=seed)
meas = edges.to_measurements()
if world == "grid3d":
    coords = np.asarray(T_true)[:, :, d].round().astype(np.int64)
    order = np.lexsort(tuple(coords[:, k] for k in range(d)))
else:
    order = np.arange(n)
new_of_old = np.empty(n, np.int64)
new_of_old[order] = np.arange(n)
meas = [dc.replace(m, p1=int(new_of_old[m.p1]), p2=int(new_of_old[m.p2]))
        for m in meas]
problem, ranges = spmd.build_spmd_problem(
    meas, n, num_agents=num_agents, r=r, dtype=jnp.float32
)

from dpgo_tpu.solvers import chordal as chordal_mod

T = np.asarray(chordal_mod.chordal_initialization_arrays(edges, n=n))
Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
X0 = np.einsum("rd,nde->nre", Y_lift, T)[order]
state = spmd.initial_state(problem, X0, ranges)

base = spmd.SPMDConfig(
    mode="all", acceleration=True, rtr_iterations=1,
    rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)),
    adaptive_restart=True,
)


def timed(tag, fn, *args):
    # a scalar reduction pulled to the host ends the timed region
    def sync(o):
        return float(jnp.sum(jax.tree.leaves(o)[0]))

    out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(out)
    dt = time.perf_counter() - t0
    print(f"{tag}: {dt*1000:.1f} ms", flush=True)
    return out


R = 10
# 1) plain engine, R rounds
run_plain = spmd.make_run_fn(problem, base, mesh=None)
timed(f"plain x{R}", lambda s: run_plain(s, R, 1e-12)[0].X, state)

# 2) certified engine (residual control), R rounds
cfg_cert = dc.replace(base, rtr_residual_control=True)
run_cert = spmd.make_run_fn(problem, cfg_cert, mesh=None)
timed(f"cert-residual x{R}", lambda s: run_cert(s, R, 1e-12)[0].X, state)

# 3) delta engine, R rounds
X64 = np.asarray(state.X, np.float64)
ref = delta_mod.build_delta_ref(problem, X64)
dstate = delta_mod.initial_delta_state(ref)
run_delta = delta_mod.make_delta_run_fn(problem, base, mesh=None)
timed(f"delta x{R}", lambda s: run_delta(ref, s, R, 1e-12)[0].D, dstate)

# 4) delta sub-ops
pr_blk = jax.tree.map(jnp.asarray, problem)
qd_static = spmd._build_qd_static(pr_blk, base)
om_p, om_s = delta_mod._omegas(pr_blk)
a_priv = (pr_blk.priv_i, pr_blk.priv_j, pr_blk.priv_T, om_p)
a_shared = (pr_blk.shared_idx, pr_blk.shared_T, om_s, pr_blk.shared_outgoing)
a_ref = (ref.res_ref_priv, ref.res_ref_shared)
D = dstate.D
pub = jax.vmap(lambda Da, idx: Da[idx])(D, pr_blk.pub_idx)
nbrD = pub[pr_blk.shared_nbr_robot, pr_blk.shared_nbr_slot]


@jax.jit
def cost_grad_all(D, nbrD):
    return jax.vmap(
        lambda pi, pj, pT, op, si, sT, os_, so, rp, rs, Da, nd:
        delta_mod._delta_cost_grad(
            (rp, rs), (pi, pj, pT, op), (si, sT, os_, so), Da, nd
        )
    )(*a_priv, *a_shared, *a_ref, D, nbrD)


timed("delta cost_grad (vmapped)", cost_grad_all, D, nbrD)


@jax.jit
def project_all(W):
    return jax.vmap(delta_mod.delta_project_lifted)(ref.X_ref, ref.M_ref, W)


timed("delta project (vmapped)", project_all, D)


@jax.jit
def tcg_all(D):
    X = ref.X_ref + D

    def one(qd, Xa, Da):
        from dpgo_tpu.solvers import rtr as rtr_mod
        eg = jnp.ones_like(Da)
        g = lifted.proj_tangent(Xa, eg)
        from dpgo_tpu import quadratic as q
        S = q.hess_correction(Xa, eg)
        return rtr_mod._tcg(qd, Xa, S, g, jnp.asarray(1.0, Da.dtype),
                            base.rtr_tcg_iterations).eta

    return jax.vmap(one)(qd_static, X, D)


timed("tcg 50-iter (vmapped)", tcg_all, D)
