#!/usr/bin/env python
"""Smoke run of the PGO main path on one GPU, checked against the CPU.

    python chip_smoke.py              # phases 0-4 on one GPU
    python chip_smoke.py --four-gpus  # only the 4-GPU agent mesh vs one GPU

Phases (one process; the plain reference is the same program on the
in-process CPU backend, so no second process ever opens the card):

  0. device   — the first JAX device is a GPU and x64 is on.
  1. central  — grid3d-10k (SE(3), r=5): chordal init + rtr_solve_auto to
                gradnorm < 1e-2 in f64, certified in host numpy f64 and
                compared with the same solve on the CPU.
  2. spmd     — city2d-10k, 5 agents, r=3, Nesterov + adaptive restart,
                200 fused f64 rounds (spmd.make_run_fn): device metrics vs
                host f64, first 20 rounds vs the CPU.
  3. delta    — the f32 anchored delta engine from the phase-2 endpoint,
                300 rounds at the default tCG precision.
  4. gnc      — city2d-1228 (INTEL's size) with 15% planted outliers,
                2 agents, 10 weight updates x 20 rounds; rejected edges vs
                the CPU's.

Each phase prints one JSON line; any failed check raises, so the script
exits non-zero and prints no result line. All data comes from the seeded
generators in dpgo_tpu/datasets.py. The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SEED = 1
# world sizes (poses) per phase
CENTRAL_POSES = 10_000
SPMD_POSES = 10_000
GNC_POSES = 1_228  # INTEL's size
MESH_POSES = 100_000


def require_gpu(jax_module):
    """Phase 0: the default device must be a GPU. Never falls back."""
    dev = jax_module.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX's first device is {dev.platform!r}"
        )
    if not jax_module.config.jax_enable_x64:
        raise RuntimeError("x64 is off; the f64 phases need it")
    return dev


def check(name, ok, **values):
    if not ok:
        raise AssertionError(f"check {name} failed: {values}")


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def emit(record):
    print(json.dumps(record), flush=True)


def lift(d, r, T):
    from dpgo_tpu.ops import lifted

    Y = np.asarray(lifted.fixed_stiefel_variable(d, r))
    return np.einsum("rd,nde->nre", Y, np.asarray(T))


# --------------------------------------------------------------------------
# Phase 1: centralized SE(3) solve
# --------------------------------------------------------------------------

def phase_centralized(jax, cpu):
    from dpgo_tpu import datasets, quadratic
    from dpgo_tpu.parallel import delta, spmd
    from dpgo_tpu.solvers import chordal, rtr

    edges, n, _ = datasets.synthesize_grid3d(CENTRAL_POSES, seed=SEED)
    d, r = 3, 5

    def solve():
        problem = quadratic.from_private_measurements(edges, n=n, d=d)
        T = chordal.chordal_initialization_arrays(edges, n=n, tol=1e-10)
        X, stats = rtr.rtr_solve_auto(
            problem, jax.numpy.asarray(lift(d, r, T)), gradnorm_tol=1e-2,
            initial_radius=100.0, max_iterations=100, max_inner=200,
        )
        return np.asarray(X), jax.tree.map(np.asarray, stats)

    t0 = time.perf_counter()
    X_gpu, st_gpu = solve()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    X_gpu, st_gpu = solve()
    t_warm = time.perf_counter() - t0
    with jax.default_device(cpu):
        t0 = time.perf_counter()
        X_cpu, st_cpu = solve()
        t_cpu = time.perf_counter() - t0

    one, _ = spmd.build_spmd_problem(edges.to_measurements(), n, 1, r)
    cost_h, gn_h = delta.host_certify(one, X_gpu[None])
    cost_hc, gn_hc = delta.host_certify(one, X_cpu[None])
    # rtr's objective is f = 0.5<XQ,X>; the host evaluates 2f from residuals
    cost_dev = 2.0 * float(st_gpu.f_opt)
    rec = {
        "phase": 1, "name": "central grid3d-10k r=5",
        "poses": n, "edges": int(edges.m),
        "seconds_first_call": t_first, "seconds_warm": t_warm,
        "seconds_cpu": t_cpu,
        "rtr_iterations": int(st_gpu.iterations),
        "tcg_iterations": int(st_gpu.tcg_iters),
        "cost_device": cost_dev, "cost_host_f64": cost_h,
        "gradnorm_device": float(st_gpu.gnorm_opt), "gradnorm_host_f64": gn_h,
        "cost_cpu": cost_hc, "gradnorm_cpu": gn_hc,
        "rtr_iterations_cpu": int(st_cpu.iterations),
    }
    emit(rec)
    check("gradnorm < 1e-2 (host f64)", gn_h < 1e-2, gn=gn_h)
    check("cpu gradnorm < 1e-2 (host f64)", gn_hc < 1e-2, gn=gn_hc)
    # Both are f64 evaluations of the same point; the device's matvec form
    # 0.5<XQ,X> cancels O(kappa |X|^2) partial sums down to the cost, which
    # costs at most ~4 of f64's 16 digits at this scale.
    check("device cost == host cost (rel 1e-9)",
          rel(cost_dev, cost_h) <= 1e-9, dev=cost_dev, host=cost_h)
    # Two runs of one f64 program that stop at gradnorm < 1e-2 land within
    # ~gradnorm^2/lambda of the optimum; the cost is O(1e4), so 1e-6
    # relative holds for any two such endpoints of this well-conditioned
    # world while catching a wrong solve.
    check("gpu optimum == cpu optimum (rel 1e-6)",
          rel(cost_h, cost_hc) <= 1e-6, gpu=cost_h, cpu=cost_hc)
    return rec


# --------------------------------------------------------------------------
# Phase 2: distributed SPMD RBCD
# --------------------------------------------------------------------------

def spmd_config(agents, tol=0.1):
    from dpgo_tpu.parallel import spmd

    return spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=tol / (2 * np.sqrt(agents)),
        adaptive_restart=True,
    )


def trace_rounds(jax, run, state, rounds):
    """`rounds` single-round launches of one compiled program: the per-round
    (cost, gradnorm) trace. Metrics are the round-start ones."""
    costs, gnorms = [], []
    for _ in range(rounds):
        state, m, _ = run(state, 1, 0.0)
        costs.append(float(m.cost))
        gnorms.append(float(m.gradnorm))
    return state, costs, gnorms


def metrics_at(jax, run, state):
    """Device (cost, gradnorm) at state.X exactly: a forced-restart round
    solves from Y = X, and a round reports its round-start metrics."""
    _, m, _ = run(state._replace(do_restart=jax.numpy.asarray(True)), 1, 0.0)
    return float(m.cost), float(m.gradnorm)


def phase_spmd(jax, cpu):
    from dpgo_tpu import datasets
    from dpgo_tpu.parallel import delta, spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    edges, n, _ = datasets.synthesize_city2d(SPMD_POSES, seed=SEED)
    meas = edges.to_measurements()
    d, r, agents = 2, 3, 5
    X0 = lift(d, r, chordal_initialization(meas))
    cfg = spmd_config(agents)

    def setup():
        problem, ranges = spmd.build_spmd_problem(meas, n, agents, r)
        state = spmd.initial_state(problem, X0, ranges)
        return problem, state, spmd.make_run_fn(problem, cfg, mesh=None)

    problem, state, run = setup()
    t0 = time.perf_counter()
    state, costs, gnorms = trace_rounds(jax, run, state, 20)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, m, rounds = run(state, 180, 0.0)
    jax.block_until_ready(state.X)
    t_bulk = time.perf_counter() - t0
    cost_dev, gn_dev = metrics_at(jax, run, state)
    X_end = np.asarray(state.X, np.float64)
    cost_h, gn_h = delta.host_certify(problem, X_end)

    with jax.default_device(cpu):
        _, state_c, run_c = setup()
        t0 = time.perf_counter()
        _, costs_c, _ = trace_rounds(jax, run_c, state_c, 20)
        t_cpu = time.perf_counter() - t0

    nb = problem.num_band
    gather_edges = int(np.sum(np.asarray(problem.priv_weight)[:, nb:] > 0))
    trace_rel = max(rel(a, b) for a, b in zip(costs, costs_c))
    rec = {
        "phase": 2, "name": "spmd city2d-10k 5 agents r=3 f64",
        "poses": n, "edges": int(edges.m),
        "band_offsets": list(problem.band_offsets),
        "gather_path_edges": gather_edges,
        "shared_edges": int(np.sum(np.asarray(problem.shared_kappa) > 0)),
        "rounds": 20 + int(rounds),
        "seconds_first_20_incl_compile": t_trace,
        "seconds_180_rounds": t_bulk, "rounds_per_s": int(rounds) / t_bulk,
        "seconds_cpu_20_incl_compile": t_cpu,
        "cost_device": cost_dev, "cost_host_f64": cost_h,
        "gradnorm_device": gn_dev, "gradnorm_host_f64": gn_h,
        "first20_cost_max_rel_vs_cpu": trace_rel,
        "cost_trace_first5": costs[:5],
    }
    emit(rec)
    check("cost decreased", cost_h < costs[0], start=costs[0], end=cost_h)
    # Same f64 point, two f64 evaluations that differ only in summation
    # order (device scatter-adds and psums vs numpy): ~1e-13 relative, so
    # 1e-8 catches any wrong edge, exchange or projection.
    check("device cost == host (rel 1e-8)", rel(cost_dev, cost_h) <= 1e-8,
          dev=cost_dev, host=cost_h)
    check("device gradnorm == host (rel 1e-8)", rel(gn_dev, gn_h) <= 1e-8,
          dev=gn_dev, host=gn_h)
    # One f64 program on two backends: rounding differs in the last bits
    # and grows through 20 rounds of trust-region and restart decisions,
    # which stay the same far from ties; 1e-6 leaves that room and catches
    # any round that does different work.
    check("first 20 rounds == cpu (rel 1e-6)", trace_rel <= 1e-6,
          gpu=costs, cpu=costs_c)
    return rec, meas, n, X_end


# --------------------------------------------------------------------------
# Phase 3: anchored delta engine (f32 on device)
# --------------------------------------------------------------------------

def delta_config(agents):
    """The bench's city cell schedule (shallow tCG cap, exact restart),
    aimed at the certified tolerance 1e-2."""
    return dataclasses.replace(
        spmd_config(agents, tol=1e-2), rtr_tcg_iterations=3,
        restart_scheme="exact",
        restart_interval=1_000_000, nesterov_n=5,
    )


def phase_delta(jax, meas, n, X_start):
    import jax.numpy as jnp

    from dpgo_tpu.parallel import delta, spmd

    agents, r = 5, 3
    problem, _ = spmd.build_spmd_problem(meas, n, agents, r, dtype=jnp.float32)
    cfg = delta_config(agents)
    # host f64 evaluations use the f32-rounded measurements the device holds
    cost0, gn0 = delta.host_certify(problem, X_start)
    t0 = time.perf_counter()
    X_end, info = delta.run_delta_certified(
        problem, X_start, cfg, tol=0.0, chunk=100, max_rounds=300,
    )
    t_run = time.perf_counter() - t0
    cost1, gn1 = delta.host_certify(problem, X_end)
    # device gradnorm at X_end exactly: fresh anchor there, forced restart
    run = delta.make_delta_run_fn(problem, cfg, reanchor_every=25)
    ref = delta.build_delta_ref(problem, X_end)
    st = delta.initial_delta_state(ref)._replace(do_restart=jnp.asarray(True))
    _, _, m, _ = run(ref, st, 1, 0.0)
    gn_dev = float(m.gradnorm)
    rec = {
        "phase": 3, "name": "delta city2d-10k 5 agents f32",
        "tcg_precision": cfg.rtr_tcg_precision,
        "rounds": info["rounds"], "seconds_incl_compile": t_run,
        "gradnorm_host_f64_start": gn0, "gradnorm_host_f64_end": gn1,
        "cost_host_f64_start": cost0, "cost_host_f64_end": cost1,
        "gradnorm_device_end": gn_dev,
        "device_trace": info["trace"],
    }
    emit(rec)
    check("host f64 gradnorm did not increase", gn1 <= gn0, start=gn0, end=gn1)
    # The device evaluates in f32 at the f32 witness of the anchor: its
    # rounding (eps32 |Y| ~ 6e-8) times the O(kappa * degree) normal part of
    # the Euclidean gradient leaks ~1e-3 of the gradnorm through the tangent
    # projection; 1e-2 relative allows that and nothing more.
    check("device gradnorm == host f64 (rel 1e-2)", rel(gn_dev, gn1) <= 1e-2,
          dev=gn_dev, host=gn1)
    return rec


# --------------------------------------------------------------------------
# Phase 4: distributed GNC outlier rejection
# --------------------------------------------------------------------------

def phase_gnc(jax, cpu):
    from dpgo_tpu import datasets
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    edges, n, _ = datasets.synthesize_city2d(GNC_POSES, seed=SEED)
    meas, planted = datasets.plant_outliers(
        edges.to_measurements(), n, frac=0.15, seed=SEED
    )
    d, r, agents = 2, 5, 2
    X0 = lift(d, r, chordal_initialization(meas))
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)

    def rejected_set():
        problem, ranges = spmd.build_spmd_problem(meas, n, agents, r)
        state = spmd.initial_state(problem, X0, ranges)
        problem_out, _, hist = spmd.run_rbcd_gnc(
            problem, state, cfg, barc=5.0, num_weight_updates=10,
            inner_rounds=20,
        )
        weights = {e["pair"]: e["weight"]
                   for e in spmd.edge_weight_table(problem_out, ranges)
                   if not e["fixed"]}
        return {p for p, w in weights.items() if w < 1e-6}, hist

    t0 = time.perf_counter()
    rejected, hist = rejected_set()
    t_gpu = time.perf_counter() - t0
    with jax.default_device(cpu):
        rejected_c, _ = rejected_set()
    tp = len(rejected & planted)
    rec = {
        "phase": 4, "name": "gnc city2d-1228 15% outliers 2 agents",
        "seconds_incl_compile": t_gpu,
        "planted": len(planted), "rejected": len(rejected),
        "precision": tp / max(len(rejected), 1),
        "recall": tp / max(len(planted), 1),
        "rejected_cpu": len(rejected_c),
        "final_cost": hist[-1]["cost"],
    }
    emit(rec)
    check("rejected set == cpu's", rejected == rejected_c,
          only_gpu=sorted(rejected - rejected_c),
          only_cpu=sorted(rejected_c - rejected))
    return rec


# --------------------------------------------------------------------------
# --four-gpus: the agent mesh over four cards vs the same run on one card
# --------------------------------------------------------------------------

def check_sharded(x, mesh_devices, agents_per_device):
    shards = x.addressable_shards
    devices = {s.device for s in shards}
    shapes = {s.data.shape[0] for s in shards}
    check("state sharded over all four cards",
          devices == set(mesh_devices) and shapes == {agents_per_device},
          devices=sorted(str(d_) for d_ in devices), shard_rows=sorted(shapes))


def four_gpus(jax):
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dpgo_tpu import datasets
    from dpgo_tpu.parallel import delta, spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    devs = jax.devices()
    check("four GPUs", len(devs) >= 4, count=len(devs))
    mesh = Mesh(np.array(devs[:4]), ("agents",))
    agents, r, rounds = 8, 3, 50
    edges, n, _ = datasets.synthesize_city2d(MESH_POSES, seed=SEED)
    meas = edges.to_measurements()
    problem, ranges = spmd.build_spmd_problem(meas, n, agents, r)
    X0 = lift(2, r, chordal_initialization(meas))
    cfg = spmd_config(agents)
    out = {"phase": "four-gpus", "poses": n, "edges": int(edges.m),
           "agents": agents, "rounds": rounds}

    traces = {}
    for name, m in (("mesh", mesh), ("one", None)):
        run = spmd.make_run_fn(problem, cfg, mesh=m)
        state = spmd.initial_state(problem, X0, ranges)
        t0 = time.perf_counter()
        state, costs, gnorms = trace_rounds(jax, run, state, rounds)
        out[f"spmd_seconds_{name}_incl_compile"] = time.perf_counter() - t0
        if m is not None:
            check_sharded(state.X, devs[:4], agents // 4)
        traces[name] = (costs, gnorms)

    cfg_d = delta_config(agents)
    X_stack = np.asarray(spmd.initial_state(problem, X0, ranges).X)
    for name, m in (("mesh", mesh), ("one", None)):
        run = delta.make_delta_run_fn(problem, cfg_d, mesh=m,
                                      reanchor_every=25)
        ref = delta.build_delta_ref(problem, X_stack, dtype=np.float64)
        st = delta.initial_delta_state(ref)
        costs, gnorms = [], []
        t0 = time.perf_counter()
        for _ in range(rounds):
            st, ref, mt, _ = run(ref, st, 1, 0.0)
            costs.append(float(mt.cost))
            gnorms.append(float(mt.gradnorm))
        out[f"delta_seconds_{name}_incl_compile"] = time.perf_counter() - t0
        if m is not None:
            check_sharded(st.D, devs[:4], agents // 4)
        traces["delta_" + name] = (costs, gnorms)

    for eng in ("", "delta_"):
        (c_m, g_m), (c_1, g_1) = traces[eng + "mesh"], traces[eng + "one"]
        out[f"{eng or 'spmd_'}cost_max_rel"] = max(map(rel, c_m, c_1))
        out[f"{eng or 'spmd_'}gradnorm_max_rel"] = max(map(rel, g_m, g_1))
        out[f"{eng or 'spmd_'}cost_first_last"] = [c_m[0], c_m[-1]]
    emit(out)
    # All f64. The mesh and the single card run the same per-agent work;
    # only the order of the cross-agent sums (psum) differs, ~1e-15
    # relative per round. 1e-6 leaves room for that to grow through 50
    # rounds of decisions and catches any wrong exchange or shard.
    for key in ("spmd_cost_max_rel", "spmd_gradnorm_max_rel",
                "delta_cost_max_rel", "delta_gradnorm_max_rel"):
        check(f"{key} <= 1e-6", out[key] <= 1e-6, value=out[key])
    return out


def main(argv):
    four = "--four-gpus" in argv
    import jax

    import dpgo_tpu  # noqa: F401  (enables x64)
    from dpgo_tpu.utils import compile_cache_dir

    dev = require_gpu(jax)
    cache = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"compile cache: {cache}", flush=True)

    if four:
        four_gpus(jax)
    else:
        cpu = jax.devices("cpu")[0]
        phase_centralized(jax, cpu)
        _, meas, n, X_end = phase_spmd(jax, cpu)
        phase_delta(jax, meas, n, X_end)
        phase_gnc(jax, cpu)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
