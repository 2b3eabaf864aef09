#!/usr/bin/env python
"""Benchmark: sphere2500 certifiable PGO solve (BASELINE.json config #2).

Headline metric: wall-clock time of the full lifted solve of sphere2500.g2o
(SE(3), 2500 poses / 4949 edges) at relaxation rank r=5 — chordal
initialization + Riemannian trust-region to global gradient norm < 1e-2 —
excluding one-time XLA compilation (programs are compiled once per problem
shape and cached).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.

vs_baseline: the reference repo publishes no numbers and cannot be built here
(its build fetches ROPTLIB from the network; this container has zero egress),
so the committed baseline in bench_baseline.json is this same workload
measured on the host CPU (single process, JAX CPU backend) — a proxy for an
optimized single-machine CPU implementation.
vs_baseline = baseline_seconds / measured_seconds (>1 means faster).

A secondary distributed-RBCD metric (8 agents, Nesterov) is reported on
stderr.
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)
# Persistent XLA compilation cache: repeat bench runs (and bench --all's
# many problem shapes) skip recompilation.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

DATA = "/root/reference/data/sphere2500.g2o"
BASELINE_FILE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bench_baseline.json"
)
RANK = 5
TOL = 1e-2
NUM_AGENTS = 8


def _load_dataset():
    from dpgo_tpu.io.g2o import read_g2o_file

    if os.path.exists(DATA):
        return read_g2o_file(DATA)
    from __graft_entry__ import _synthetic_se3_chain

    return _synthetic_se3_chain(2500, 2400, seed=1)


def run_centralized(meas, n, verbose=False):
    """Config #2: chordal init + centralized RTR at r=5, time to tol."""
    import jax.numpy as jnp

    from dpgo_tpu import quadratic
    from dpgo_tpu.measurements import EdgeArrays
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.solvers import chordal as chordal_mod
    from dpgo_tpu.solvers import rtr as rtr_mod

    d = meas[0].d
    edges = EdgeArrays.from_measurements(meas)
    problem = quadratic.from_private_measurements(edges, n=n, d=d)
    Y_lift = jnp.asarray(lifted.fixed_stiefel_variable(d, RANK))

    # native f64 throughout, the reference's own precision

    def full_solve():
        T = chordal_mod.chordal_initialization_arrays(edges, n=n, tol=1e-10)
        X0 = jnp.einsum("rd,nde->nre", Y_lift, T)
        # measured preconditioner selection: cheap block-Jacobi probe,
        # exact banded factor only on a measured stall (see rtr_solve_auto)
        X, stats = rtr_mod.rtr_solve_auto(
            problem, X0, gradnorm_tol=TOL, initial_radius=100.0,
            max_iterations=100, max_inner=200,
        )
        return X, stats

    # warm up (compile)
    X, stats = full_solve()
    np.asarray(X)

    # min of 3 timed repeats: the minimum is the standard noise-robust
    # statistic for a deterministic workload
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        X, stats = full_solve()
        np.asarray(X)
        elapsed = min(elapsed, time.perf_counter() - t0)
    return {
        "elapsed_s": elapsed,
        "gradnorm": float(stats.gnorm_opt),
        "cost": 2 * float(stats.f_opt),
        "rtr_iterations": int(stats.iterations),
        "tcg_iterations": int(stats.tcg_iters),
        "converged": float(stats.gnorm_opt) < TOL,
    }


def run_distributed(meas, n):
    """Secondary: 8-agent accelerated RBCD (SPMD, fused loop), time to tol,
    in native f64."""
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    d = meas[0].d
    T = chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=NUM_AGENTS, r=RANK)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, RANK))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state0 = spmd.initial_state(problem, X0, ranges)
    cfg = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=TOL / (2 * np.sqrt(NUM_AGENTS)),
        adaptive_restart=True,
        # tuned Nesterov schedule (scripts/tune_schedule.py winners; in
        # mode='all' every block updates per round, so a smaller effective
        # team size is admissible and the adaptive restart trigger alone
        # beats periodic restarts)
        restart_interval=10**6, nesterov_n=5,
    )
    # with an f64 cfg this is a single program launched in chunks
    run_fn = spmd.make_two_phase_run_fn(problem, cfg, mesh=None)
    s_warm = run_fn.warmup(state0)
    np.asarray(s_warm.X)

    t0 = time.perf_counter()
    state, metrics, total_rounds = run_fn(state0, 900, TOL)
    gradnorm = float(metrics.gradnorm)
    np.asarray(state.X)
    elapsed = time.perf_counter() - t0
    return {
        "elapsed_s": elapsed,
        "rounds": total_rounds,
        "rounds_per_s": total_rounds / elapsed,
        "gradnorm": gradnorm,
        "cost": float(metrics.cost),
    }


def main():
    import jax

    meas, n = _load_dataset()
    central = run_centralized(meas, n)

    baseline_s = None
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            baseline_s = json.load(f).get("sphere2500_central_solve_s")
    vs = (baseline_s / central["elapsed_s"]) if baseline_s else 1.0
    print(
        json.dumps(
            {
                "metric": "sphere2500 chordal init + RTR solve (r=5) to gradnorm<1e-2",
                "value": round(central["elapsed_s"], 3),
                "unit": "s",
                "vs_baseline": round(vs, 3),
            }
        )
    )
    central["platform"] = jax.devices()[0].platform
    print("centralized: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in central.items()}
    ), file=sys.stderr)

    dist = None
    if "--skip-distributed" not in sys.argv:
        dist = run_distributed(meas, n)
        print("distributed-rbcd: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in dist.items()}
        ), file=sys.stderr)

    if "--all" in sys.argv:
        # BASELINE.json configs #3 (city10000, 5 agents) and #4 (INTEL GNC)
        # and the async-vs-sync datapoint. --json-out=PATH writes the full
        # matrix.
        all_out = {
            "platform": jax.devices()[0].platform,
            "sphere2500-central": central,
            "sphere2500-rbcd8": dist,
        }
        for name, fn in [("city10000-rbcd5", run_city10000),
                         ("intel-gnc", run_intel_gnc),
                         ("intel-gnc-outliers", run_intel_gnc_outliers),
                         ("sphere2500-async-vs-sync", run_sphere2500_async)]:
            all_out[name] = fn()
            print(f"{name}: " + json.dumps(all_out[name]), file=sys.stderr)
        for arg in sys.argv:
            if arg.startswith("--json-out="):
                with open(arg.split("=", 1)[1], "w") as f:
                    json.dump(all_out, f, indent=1)
    else:
        for arg in sys.argv:
            if arg.startswith("--json-out="):
                # honor --json-out without --all rather than silently
                # dropping it: write the partial (headline-only) dict
                print("warning: --json-out without --all writes only the "
                      "headline configs", file=sys.stderr)
                with open(arg.split("=", 1)[1], "w") as f:
                    json.dump({
                        "platform": jax.devices()[0].platform,
                        "sphere2500-central": central,
                        "sphere2500-rbcd8": dist,
                    }, f, indent=1)


def run_city10000():
    """Config #3: multi-robot synchronous RBCD (5 agents), city10000 (SE2)."""
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    import jax.numpy as jnp

    from dpgo_tpu.measurements import EdgeArrays
    from dpgo_tpu.solvers import chordal as chordal_mod

    meas, n = read_g2o_file("/root/reference/data/city10000.g2o")
    d, r, agents = 2, 3, 5
    # the reference's multi-robot example stops at global gradnorm < 0.1
    # (MultiRobotExample.cpp:229); 1e-2 is the per-agent local tol
    tol = 0.1
    T = np.asarray(
        chordal_mod.chordal_initialization_arrays(
            EdgeArrays.from_measurements(meas), n=n, tol=1e-10, maxiter=1000,
        )
    )
    # f32 problem: the anchored delta engine is the f32-state design (its
    # accuracy comes from residual anchoring, certified in host f64 below)
    problem, ranges = spmd.build_spmd_problem(
        meas, n, num_agents=agents, r=r, dtype=jnp.float32
    )
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state = spmd.initial_state(problem, X0, ranges)
    cfg = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=tol / (2 * np.sqrt(agents)),
        adaptive_restart=True,
    )
    # To-tolerance endpoint (the reference example's stop rule is the
    # GLOBAL gradnorm < 0.1, MultiRobotExample.cpp:229): the anchored delta
    # engine with the 'exact' restart signal and a SHALLOW tCG cap drives
    # the block-coordinate tail straight through the 0.5 gradnorm floor the
    # r4 bench stalled at. Deep tCG against stale neighbor blocks over-solves
    # the local subproblem — at city2d-100k a cap of 3 HALVED the global
    # round count vs 20 — so the shallow cap is part of the schedule. The
    # endpoint is certified on the host in f64 (honest metric,
    # independent of device precision), with the duality gap against the
    # dataset's dual-certified optimum 638.6246 (docs/PARITY.md).
    from dpgo_tpu.parallel import delta as delta_mod

    import dataclasses as _dc

    cfg = _dc.replace(
        cfg, rtr_tcg_iterations=3, restart_scheme="exact",
        restart_interval=1_000_000, nesterov_n=5,
        rtr_inner_dtype=None,
    )
    X0_stacked = np.asarray(state.X, np.float64)
    # warmup execution: compile the fused delta chunk once (the headline
    # configs also exclude one-time XLA compilation)
    delta_mod.run_delta_certified(
        problem, X0_stacked, cfg, tol=0.9 * tol, mesh=None, chunk=250,
        max_rounds=1,
    )
    t0 = time.perf_counter()
    # round budget: the 5-agent tail crossed 0.1 at ~5k delta rounds
    X_final, info = delta_mod.run_delta_certified(
        problem, X0_stacked, cfg, tol=0.9 * tol, mesh=None, chunk=250,
        max_rounds=12000,
    )
    cost_h, gn_h = delta_mod.host_certify(problem, X_final)
    optimum = 638.6246  # dual-certified (tests/test_certify.py)
    return {
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "rounds": info["rounds"],
        "gradnorm": round(gn_h, 5),
        "cost": round(cost_h, 4),
        "cost_gap_vs_certified_optimum": round((cost_h - optimum) / optimum, 7),
        "to_tolerance": bool(gn_h < tol),
    }


def run_sphere2500_async():
    """Asynchronous RBCD datapoint (VERDICT r3 #7): semantic-async SPMD
    (Poisson-thinned per-agent updates inside the bulk-synchronous round —
    the device-resident counterpart of the reference's per-agent Exp(rate)
    optimization threads, PGOAgent.cpp:486-499) vs the synchronous mode='all'
    engine, both UNaccelerated (the reference forbids acceleration in async
    mode, PGOAgent.cpp:477), sphere2500 / 8 agents, time and rounds to the
    example tolerance 0.1."""
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    meas, n = _load_dataset()
    d = meas[0].d
    tol = 0.1
    T = chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=NUM_AGENTS, r=RANK)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, RANK))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state0 = spmd.initial_state(problem, X0, ranges)

    out = {}
    for mode in ("async", "all"):
        cfg = spmd.SPMDConfig(
            mode=mode, acceleration=False, rtr_iterations=1,
            rtr_gradnorm_tol=tol / (2 * np.sqrt(NUM_AGENTS)),
        )
        run_fn = spmd.make_two_phase_run_fn(problem, cfg, mesh=None)
        s_warm = run_fn.warmup(state0)
        np.asarray(s_warm.X)
        t0 = time.perf_counter()
        state, metrics, rounds = run_fn(state0, 3000, tol)
        np.asarray(state.X)
        out[mode] = {
            "elapsed_s": round(time.perf_counter() - t0, 2),
            "rounds": int(rounds),
            "gradnorm": round(float(metrics.gradnorm), 5),
            "cost": round(float(metrics.cost), 3),
        }
    return out


def run_intel_gnc():
    """Config #4: GNC robust PGO on input_INTEL_g2o.g2o (SE2, distributed)."""
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    meas, n = read_g2o_file("/root/reference/data/input_INTEL_g2o.g2o")
    d, r, agents = 2, 3, 2
    T = chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=agents, r=r)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state = spmd.initial_state(problem, X0, ranges)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    # warm pass: the r4 artifact recorded 103-157 s dominated by first
    # compiles (VERDICT r4 #8); the headline configs exclude one-time
    # compilation, so this one now does too — run the full pipeline once
    # to populate the in-process compile cache, time the second run
    spmd.run_rbcd_gnc(problem, state, cfg, barc=5.0, num_weight_updates=10,
                      inner_rounds=20)
    t0 = time.perf_counter()
    problem_out, state_out, hist = spmd.run_rbcd_gnc(
        problem, state, cfg, barc=5.0, num_weight_updates=10, inner_rounds=20
    )
    w = np.asarray(problem_out.priv_weight)
    fx = np.asarray(problem_out.priv_fixed_weight)
    free = ~fx & (np.asarray(problem_out.priv_kappa) > 0)
    rejected = int(((w < 1e-6) & free).sum())
    total = int(free.sum())
    return {
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "rejected_lcs": rejected,
        "free_lcs": total,
        "final_cost": round(hist[-1]["cost"], 3),
    }


def run_intel_gnc_outliers(frac=0.15, seed=1):
    """GNC rejection at dataset scale (VERDICT r4 #6): plant uniformly
    random outlier loop closures into input_INTEL (15% of the genuine LC
    count, full-confidence information), run the distributed GNC-TLS path,
    and score rejection precision/recall against the planted ground truth
    plus the final cost evaluated on the CLEAN edge set only (host f64)
    against the clean-solve anchor. The reference's own GNC example runs a
    clean input (SingleRobotGNCExample.cpp); this config demonstrates the
    capability the pipeline exists for (DPGO_solver.cpp:335-412)."""
    import json as _json

    from dpgo_tpu.datasets import plant_outliers
    from dpgo_tpu.io.g2o import read_g2o_file
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import delta as delta_mod
    from dpgo_tpu.parallel import spmd
    from dpgo_tpu.solvers.pgo import chordal_initialization

    meas, n = read_g2o_file("/root/reference/data/input_INTEL_g2o.g2o")
    meas_c, planted = plant_outliers(meas, n, frac=frac, seed=seed)
    # r=5 matches the centralized parity anchor (tests/dataset_costs.json),
    # so cost_on_clean_edges is directly comparable to the clean optimum
    d, r, agents = 2, 5, 2
    T = chordal_initialization(meas_c)
    problem, ranges = spmd.build_spmd_problem(meas_c, n, num_agents=agents, r=r)
    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)
    state = spmd.initial_state(problem, X0, ranges)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    t0 = time.perf_counter()
    problem_out, state_out, hist = spmd.run_rbcd_gnc(
        problem, state, cfg, barc=5.0, num_weight_updates=10, inner_rounds=20
    )
    elapsed = time.perf_counter() - t0
    # score: every non-fixed real edge, planted vs rejected (w < 1e-6).
    # shared edges carry two copies with identical weights — dedup by pair.
    by_pair = {}
    for e in spmd.edge_weight_table(problem_out, ranges):
        if not e["fixed"]:
            by_pair[e["pair"]] = e["weight"]
    rejected = {p for p, w in by_pair.items() if w < 1e-6}
    tp = len(rejected & planted)
    fp = len(rejected - planted)
    fn = len(planted - rejected)
    # converge the inlier solve: accelerated certified polish on the
    # reweighted problem (the GNC phases themselves run unaccelerated, as
    # the reference forbids acceleration under robust costs,
    # PGOAgent.cpp:477), then evaluate on the CLEAN edge set only (f64)
    cfg_cert = spmd.SPMDConfig(
        mode="all", acceleration=True, adaptive_restart=True,
        rtr_iterations=1, rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(agents)),
    )
    t0b = time.perf_counter()
    X_final, _info = delta_mod.run_delta_certified(
        problem_out, np.asarray(state_out.X, np.float64), cfg_cert,
        tol=1e-2, chunk=25, max_rounds=1000,
    )
    polish_s = time.perf_counter() - t0b
    problem_clean, _ = spmd.build_spmd_problem(meas, n, num_agents=agents, r=r)
    cost_clean, gnorm_clean = delta_mod.host_certify(problem_clean, X_final)
    anchor = None
    anchor_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "dataset_costs.json")
    if os.path.exists(anchor_path):
        with open(anchor_path) as f:
            table = _json.load(f)
        entry = table.get("input_INTEL_g2o.g2o")
        if isinstance(entry, dict):
            anchor = entry.get("cost")
    return {
        "gnc_s": round(elapsed, 2),
        "polish_s": round(polish_s, 2),
        "planted": len(planted),
        "rejected": len(rejected),
        "true_pos": tp, "false_pos": fp, "false_neg": fn,
        "precision": round(tp / max(tp + fp, 1), 4),
        "recall": round(tp / max(tp + fn, 1), 4),
        "cost_on_clean_edges_f64": round(float(cost_clean), 3),
        "gradnorm_on_clean_edges_f64": round(float(gnorm_clean), 4),
        "clean_anchor_cost": anchor,
        "final_gnc_cost": round(hist[-1]["cost"], 3),
    }


if __name__ == "__main__":
    main()
