#!/usr/bin/env python
"""Scale experiment: RBCD rounds/sec at varying problem sizes.

Usage: python scripts/scale_bench.py [num_poses] [num_agents] [rounds] [dtype]
Runs on whatever platform JAX selects (set JAX_PLATFORMS=cpu for the CPU
baseline). Every platform runs the same native-precision configuration.

DPGO_SCALE_WORLD selects the synthetic world:
* grid3d (default) — SE(3) lattice (grid3D family). After raster relabeling
  ~100% of edges ride dense band lanes: the friendliest matvec possible.
* city2d — SE(2) Manhattan world (the g2o100k / city10000 family named by
  BASELINE.json config #5). Loop closures land at random pose-id offsets, so
  band coverage stays at the odometry fraction (~50%) and the gather path
  does real work — the structure the north-star claim must transfer to.

Two scale-specific optimizations:
* Pose relabeling to raster (lexicographic lattice) order: the synthetic
  grid world's snake-path ids spread the lattice-neighbor offsets over ~s
  distinct values; under raster labels they concentrate on {1, s, s^2}, so
  nearly every edge gets a dense band lane (see quadratic.plan_bands).
  Pose ids are arbitrary labels — this changes nothing about the problem.
"""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import numpy as np


def main():
    num_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    num_agents = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    dtype_s = sys.argv[4] if len(sys.argv) > 4 else "f64"
    seed = 1

    import jax
    import jax.numpy as jnp

    from dpgo_tpu.datasets import synthesize_city2d, synthesize_grid3d
    from dpgo_tpu.ops import lifted
    from dpgo_tpu.parallel import spmd

    world = os.environ.get("DPGO_SCALE_WORLD", "grid3d")
    dtype = jnp.float64 if dtype_s == "f64" else jnp.float32
    t0 = time.perf_counter()
    if world == "grid3d":
        edges, n, T_true = synthesize_grid3d(num_poses, seed=seed)
        d = 3
    else:
        edges, n, T_true = synthesize_city2d(num_poses, seed=seed)
        d = 2
    meas = edges.to_measurements()
    print(f"synthesize[{world}]: {time.perf_counter()-t0:.1f}s, "
          f"{edges.m} edges", file=sys.stderr)

    # chordal initialization in the ORIGINAL (odometry-chain) labeling
    r = int(os.environ.get("DPGO_SCALE_R", "5" if d == 3 else "3"))
    from dpgo_tpu.solvers import chordal as chordal_mod

    t0 = time.perf_counter()
    T = np.asarray(chordal_mod.chordal_initialization_arrays(edges, n=n))
    print(f"chordal init: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    if world == "grid3d":
        # relabel poses to raster order (coords = ground-truth translations):
        # the lattice world's neighbor offsets concentrate on {1, s, s^2}
        coords = np.asarray(T_true)[:, :, 3].round().astype(np.int64)
        order = np.lexsort((coords[:, 0], coords[:, 1], coords[:, 2]))
    else:
        # city world: ids are already path order (odometry = offset 1); loop
        # closures sit at revisit-time offsets no relabeling can laneify
        order = np.arange(n)
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)
    import dataclasses as _dc

    meas = [
        _dc.replace(m, p1=int(new_of_old[m.p1]), p2=int(new_of_old[m.p2]))
        for m in meas
    ]

    t0 = time.perf_counter()
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=num_agents, r=r, dtype=dtype)
    print(f"build problem: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    Y_lift = np.asarray(lifted.fixed_stiefel_variable(d, r))
    X0 = np.einsum("rd,nde->nre", Y_lift, T)[order]
    state = spmd.initial_state(problem, X0, ranges)

    cfg = spmd.SPMDConfig(
        mode="all", acceleration=True, rtr_iterations=1,
        rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(num_agents)),
        adaptive_restart=True,
        # tuned schedule (scripts/tune_delta.py / tune_schedule.py winners),
        # the same on every platform: adaptive-restart-only + nesterov_n=5
        # cut rounds-to-tol ~19% at 10k and 686 -> 471 at 100k.
        # tCG cap by world: on the city graph the Steihaug theta-rule sends
        # tail rounds to the cap, and deep block-local steps against stale
        # neighbors also DOUBLE the global round count (city2d-100k: 424
        # rounds at cap 3). The lattice keeps 20 (lane-fed tCG is cheap
        # there; 133 vs 143 rounds at 10k).
        rtr_tcg_iterations=int(os.environ.get(
            "DPGO_SCALE_TCG_ITERS", "3" if world == "city2d" else "20")),
        restart_interval=int(
            os.environ.get("DPGO_SCALE_RESTART_INT", "1000000")),
        nesterov_n=(lambda v: None if v == "" else int(v))(
            os.environ.get("DPGO_SCALE_NESTEROV_N", "5")),
        # Cancellation-free restart signal (delta engine only; plain engine
        # always compares costs): the f32 cost comparison fires on rounding
        # noise once the true per-round decrease drops below eps*|f|, and
        # the noise restarts kill the Nesterov momentum exactly in the
        # certified tail. 'exact' reproduces the same function comparison
        # in delta space (one extra residual-form matvec per round) and is
        # the certified default: city2d-100k 881 rounds vs 1598 with
        # 'cost', city2d-10k 120 vs 149.
        restart_scheme=os.environ.get("DPGO_SCALE_RESTART_SCHEME", "exact"),
    )
    # guard against env overrides reaching a divergent configuration:
    # Jacobi-parallel Nesterov with periodic restarts disabled (or a
    # team-size override below the true count) is only safe under the
    # adaptive (function-scheme) restart trigger (ADVICE r3)
    if cfg.restart_interval > 10_000 or (
            cfg.nesterov_n is not None and cfg.nesterov_n < num_agents):
        assert cfg.adaptive_restart, (
            "restart_interval disabled / nesterov_n < team size requires "
            "adaptive_restart=True")
    lane_cover = float(np.mean(
        np.isin(np.asarray(problem.priv_j) - np.asarray(problem.priv_i),
                np.asarray(problem.band_offsets))
        [np.asarray(problem.priv_weight) > 0]
    )) if len(problem.band_offsets) else 0.0
    print(f"band_offsets={problem.band_offsets} num_band={problem.num_band} "
          f"mp_max={problem.priv_i.shape[1]} lane_coverage={lane_cover:.2f}",
          file=sys.stderr)
    run = spmd.make_run_fn(problem, cfg, mesh=None)

    # Certified pipeline: phase 1 = plain f32 bulk descent (this engine),
    # phase 2 = anchored delta-state engine (parallel/delta.py) below the
    # f32 quantization floor, final HONEST certification = pure-numpy f64
    # evaluation on the host. Reports total wall time to certified
    # gradnorm < DPGO_SCALE_TOL. Requires dtype=f32.
    if os.environ.get("DPGO_SCALE_CERTIFIED") == "1":
        import dataclasses as _dc2

        from dpgo_tpu.parallel import delta as delta_mod

        tol = float(os.environ.get("DPGO_SCALE_TOL", "1e-2"))
        coarse = float(os.environ.get("DPGO_SCALE_COARSE_TOL", str(10 * tol)))
        chunk = int(os.environ.get("DPGO_SCALE_CHUNK", "25"))
        # pure-f32 state: accurate trust-region control comes from the
        # residual form (HIGHEST-precision, cancellation-free), not from
        # mixed-precision machinery
        tcg_prec = os.environ.get("DPGO_SCALE_TCG_PREC", "high")
        # schedule knobs are set in the base cfg above
        cfg = _dc2.replace(
            cfg, rtr_residual_control=True, rtr_inner_control_matvecs=False,
            rtr_inner_dtype=None,
            rtr_tcg_precision=None if tcg_prec == "none" else tcg_prec,
        )
        t0 = time.perf_counter()
        # phase 1: bulk descent on the PLAIN f32 engine (`run`) to the
        # coarse tolerance. The fused driver stops at `coarse` on device; a
        # plateau guard hands off to the delta engine early when the f32
        # engine's quantization floor sits above `coarse`.
        p1_chunk = int(os.environ.get("DPGO_SCALE_P1_CHUNK", str(4 * chunk)))
        # Delta-only is the certified default (DPGO_SCALE_SKIP_P1=0 opts the
        # f32 bulk phase back in): the plain engine's f32 device gradnorm is
        # quantization-floored at 10k+ scale (grid3d-10k: stuck ~300, city2d-
        # 100k: ~600, while the delta engine evaluates the same states at
        # 0.8), so phase 1 burns its plateau budget with a blind stop
        # metric.
        skip_p1 = os.environ.get("DPGO_SCALE_SKIP_P1", "1") == "1"
        s1, total1 = state, 0
        m1 = None
        best_gn = float("inf")
        flat_chunks = 0
        while not skip_p1 and total1 < rounds:
            s1, m1, r1 = run(s1, min(p1_chunk, rounds - total1), coarse)
            total1 += int(r1)
            gn1 = float(m1.gradnorm)
            print(f"  phase1 round {total1}: device gradnorm={gn1:.4f}",
                  file=sys.stderr, flush=True)
            if gn1 < coarse:
                break
            flat_chunks = flat_chunks + 1 if gn1 > 0.99 * best_gn else 0
            best_gn = min(best_gn, gn1)
            if flat_chunks >= 2:
                print("phase1 plateaued above the coarse tolerance "
                      "(f32 floor); handing off to the delta engine",
                      file=sys.stderr)
                break
        t1 = time.perf_counter() - t0
        print(f"phase1 (f32 bulk): {total1} rounds, {t1:.1f}s, "
              f"device gradnorm="
              f"{float(m1.gradnorm) if m1 is not None else float('inf'):.4f}",
              file=sys.stderr)
        # phase 2: delta engine to the certified tolerance
        X64 = np.asarray(s1.X, np.float64)
        t0b = time.perf_counter()
        X_final, info = delta_mod.run_delta_certified(
            problem, X64, cfg, tol=0.9 * tol, mesh=None, chunk=chunk,
            max_rounds=rounds, verbose=True,
            reanchor_every=int(os.environ.get("DPGO_SCALE_REANCHOR", "25")),
        )
        t2 = time.perf_counter() - t0b
        cost_h, gnorm_h = delta_mod.host_certify(problem, X_final)
        total_s = t1 + t2
        print(
            f"CERTIFIED platform={jax.devices()[0].platform} world={world} "
            f"n={num_poses} "
            f"agents={num_agents} phase1_rounds={total1} "
            f"phase2_rounds={info['rounds']} wall_s={total_s:.2f} "
            f"host_f64_gradnorm={gnorm_h:.6f} host_f64_cost={cost_h:.2f} "
            f"certified={'YES' if gnorm_h < tol else 'NO'}"
        )
        # save the final iterate for the offline GLOBAL-optimality
        # certificate (scripts/certify_scale.py re-synthesizes the world,
        # replays the relabeling, and runs solvers.certify.certify_solution
        # on CPU f64) — gradnorm-certified above, dual-certified offline
        save_x = os.environ.get("DPGO_SCALE_SAVE_X")
        if save_x:
            # flatten the (N, n_max, r, dh) stacked iterate to the global
            # (n, r, dh) layout certify_scale.py consumes
            X_flat = np.zeros((num_poses, r, d + 1))
            for a, (s_i, e_i) in enumerate(ranges):
                X_flat[s_i:e_i] = np.asarray(X_final, np.float64)[a, : e_i - s_i]
            np.savez(save_x + ".tmp.npz", X=X_flat,
                     order=order, world=world, num_poses=num_poses,
                     seed=seed, r=r)
            os.replace(save_x + ".tmp.npz", save_x)
            print(f"saved final iterate to {save_x}", file=sys.stderr)
        return

    t0 = time.perf_counter()
    s1, m1, r1 = run(state, 1, 1e-9)
    jax.block_until_ready(s1.X)
    print(f"compile+1round: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    # launches of `chunk` rounds, so progress prints between them
    chunk = max(1, min(rounds, 25))
    # DPGO_SCALE_TOL: stop at a global gradnorm tolerance (time-to-tol runs)
    tol = float(os.environ.get("DPGO_SCALE_TOL", "1e-9"))
    t0 = time.perf_counter()
    s2, total = state, 0
    m2 = m1
    while total < rounds and float(m2.gradnorm) >= tol:
        s2, m2, r2 = run(s2, min(chunk, rounds - total), tol)
        total += int(r2)
        print(f"  round {total}: gradnorm={float(m2.gradnorm):.4f} "
              f"cost={float(m2.cost):.2f} "
              f"({time.perf_counter()-t0:.0f}s)",
              file=sys.stderr, flush=True)
    jax.block_until_ready(s2.X)
    dt = time.perf_counter() - t0
    print(
        f"platform={jax.devices()[0].platform} world={world} "
        f"dtype={dtype_s} n={num_poses} "
        f"agents={num_agents}: {total} rounds in {dt:.2f}s = "
        f"{total/dt:.2f} rounds/s | gradnorm={float(m2.gradnorm):.4f} "
        f"cost={float(m2.cost):.1f}"
    )


if __name__ == "__main__":
    main()
