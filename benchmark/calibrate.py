#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3]

For each seed, in one process: the run's inputs drawn as `run.py` draws
them, one solve of the cell's program in the configuration's precision,
and the numbers `run.py` compares (reference gradnorm, the program's
gradnorm and cost gaps, distance from the manifold). For each control seed,
the same with the program's float32 path switched on (the precision below
the configuration's float64): the control, which has to fail a limit.
One JSON line per solve on standard output.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

CONTROL_DTYPE = {"float64": "float32"}


def readings(world, config, traffic, loop, seed, dtype):
    shuffled, lift = run.draw(world, int(config["r"]), seed)
    t0 = time.perf_counter()
    solver = loop.prepare(run.program_edges(shuffled), shuffled, config,
                          traffic, lift, dtype=dtype)
    record = solver.readback(solver.dispatch())
    seconds = time.perf_counter() - t0
    _, checks = run.check(world, solver, [record], traffic, limits={
        "gradnorm_gap": 0.0, "cost_gap": 0.0, "off_manifold": 0.0})
    counters = {k: record[k] for k in ("rounds", "rtr_iters", "tcg_iters")
                if k in record}
    return {"seed": seed, "dtype": dtype, "capped": record["capped"],
            "seconds_incl_build": seconds, **counters,
            **{k: c["value"] for k, c in checks.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    spec = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, loop, _ = run.resolve_cell(spec, args.workload)

    import jax

    jax.config.update("jax_enable_x64", True)
    run.require_devices(jax, int(cell["chips"]))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(ROOT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    world = run.make_world(config)
    dtype = config.get("dtype", "float64")
    sides = [(dtype, args.seeds), (CONTROL_DTYPE[dtype], args.control_seeds)]
    for side_dtype, seeds in sides:
        for seed in (int(s) for s in seeds.split(",") if s):
            line = readings(world, config, traffic, loop, seed, side_dtype)
            print(json.dumps({"cell": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except run.BenchError as e:
        print(f"calibrate: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
