#!/usr/bin/env python3
"""Benchmark: time to a certified pose-graph solve on one GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell names a configuration (a world
and its team, `configs/<name>.json`) and a traffic mix (a solve loop and its
schedule, `traffic/<name>.json`, whose `kind` names `loops/<kind>.py`).
Everything is found by the names in BENCHMARK.json; a new cell, world,
mix or per-layer metric (`metrics/<name>.py`) is new files plus entries.

A run makes the configuration's world, then draws from `--seed` the order
in which its edges reach the solver and the r x d Stiefel matrix that lifts
the initial iterate. Neither changes the work of a solve: the solvers are
equivariant under a rotation of the lifted space and a permutation of the
edge list, so every seed does the same rounds and iterations on different
numbers. Set-up builds the cell's programs and runs them once; JAX's
persistent compile cache is `.jax_cache` in the checkout, whatever the
environment says, so that two checkouts share no cache.
The window then runs whole solves back to back, starting a new one while
less than `--seconds` have passed, and ends when the last one's result is on
the host. With `--trace 1`, one solve under `jax.profiler` comes first; the
per-layer metrics (`metrics/<name>.py`) read its trace (`trace.py`) and the
window's solves. Once the window has closed, every solve's final iterate is
checked against the plain reference (`reference.py`) and the cell's limits
(`limits/<cell>.json`).

Standard output: the card's name, clocks and power beside the window, the
cell's edge counts, the number of compilations inside the window (must be
0), and last one JSON line: `correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` also `breakdown`, and last `checks`: each number
compared beside its limit. The checks are also the last lines on standard
error.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import reference, worlds  # noqa: E402
from benchmark import trace as trace_mod  # noqa: E402

BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
SMI_QUERY = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


class BenchError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


# --------------------------------------------------------------------------
# What the names in BENCHMARK.json point to
# --------------------------------------------------------------------------

def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(directory, name):
    """The module `<directory>/<name>.py`, loaded by its path."""
    path = os.path.join(directory, name + ".py")
    if not os.path.isfile(path):
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{os.path.basename(directory)}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve_cell(spec, workload, root=ROOT, bench_dir=BENCH_DIR):
    """(cell, config, traffic, loop module, per-layer metric entries)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"unknown workload {workload!r}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     cell["traffic"] + ".json"))
    loop = load_module(os.path.join(bench_dir, "loops"), traffic["kind"])
    moved = {m["name"] for m in reported(spec["end_to_end"], workload)}
    per_layer = reported(spec["per_layer"], workload,
                         default=lambda m: m["moves"] in moved)
    return cell, config, traffic, loop, per_layer


def reported(metrics, workload, default=lambda metric: True):
    """The metrics a cell reports: those that list it, and those without a
    list that `default` admits."""
    return [m for m in metrics
            if (workload in m["workloads"] if "workloads" in m
                else default(m))]


def make_world(config):
    module_name, _, function = config["generator"].rpartition(".")
    module = worlds if module_name in ("", "worlds") else load_module(
        BENCH_DIR, module_name)
    world = getattr(module, function)(**config["params"])
    if world.m != config["edges"] or world.n != config["poses"]:
        raise BenchError(f"world has {world.n} poses and {world.m} edges, "
                         f"the configuration says {config['poses']} and "
                         f"{config['edges']}")
    return world


def draw(world, r, seed):
    """The run's inputs from its seed: an order of the edges and a Haar-
    random r x d Stiefel lifting matrix."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(world.m)
    shuffled = worlds.World(
        d=world.d, n=world.n, p1=world.p1[order], p2=world.p2[order],
        R=world.R[order], t=world.t[order], kappa=world.kappa[order],
        tau=world.tau[order])
    Q, Rq = np.linalg.qr(rng.standard_normal((r, world.d)))
    lift = Q * np.sign(np.diag(Rq))[None, :]
    return shuffled, lift


def program_edges(world):
    """The world as the program's edge arrays (no robot ids, unit weights;
    odometry edges carry the fixed-weight flag)."""
    from dpgo_tpu.measurements import EdgeArrays

    m = world.m
    return EdgeArrays(
        r1=np.zeros(m, np.int32), r2=np.zeros(m, np.int32),
        p1=world.p1, p2=world.p2, R=world.R, t=world.t,
        kappa=world.kappa, tau=world.tau, weight=np.ones(m),
        fixed_weight=(world.p1 + 1 == world.p2),
    )


# --------------------------------------------------------------------------
# The device, its clocks and the compile counter
# --------------------------------------------------------------------------

def require_devices(jax, chips):
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise BenchError(f"needs a GPU; JAX's first device is "
                         f"{devices[0].platform!r}")
    if len(devices) < chips:
        raise BenchError(f"the cell needs {chips} GPUs, JAX finds "
                         f"{len(devices)}")
    return devices[:chips]


@contextlib.contextmanager
def smi_sampler(out):
    """Samples the card's clocks and power every 5 s by `nvidia-smi` in a
    child process (which never touches JAX); appends the rows to `out`.
    Every query stalls the driver for some milliseconds, which a launch-
    bound solve feels, so the samples are sparse."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        yield
        return
    child = subprocess.Popen(
        [exe, f"--query-gpu={SMI_QUERY}", "--format=csv,noheader",
         "-l", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        child.terminate()
        try:
            text, _ = child.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            text, _ = child.communicate()
        out.extend(line for line in text.splitlines() if line.strip())


class CompileCounter:
    """Counts executables built (compiled or loaded from the persistent
    cache) while it is open."""

    def __init__(self, jax):
        self._monitoring = jax.monitoring
        self.count = 0

    def _listener(self, event, duration, **kwargs):
        if event == BACKEND_COMPILE_EVENT:
            self.count += 1

    def __enter__(self):
        self._monitoring.register_event_duration_secs_listener(self._listener)
        return self

    def __exit__(self, *exc):
        self._monitoring.unregister_event_duration_listener(self._listener)


# --------------------------------------------------------------------------
# The window, the checks and the result
# --------------------------------------------------------------------------

def timed_solve(jax, solver, traced=False):
    """One solve, its phases annotated for the profiler; the record, with
    the solve's wall seconds. The result's device buffers are dropped once
    it is on the host, so that the next solve allocates as this one did."""
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation("bench.solve"):
        handle = solver.dispatch()
    with jax.profiler.TraceAnnotation("bench.readback"):
        record = solver.readback(handle)
    del handle
    record["seconds"] = time.perf_counter() - t0
    record["traced"] = traced
    return record


def run_window(jax, solver, seconds):
    """Whole solves back to back until `seconds` have passed; returns
    (records, window seconds)."""
    records = []
    t0 = time.perf_counter()
    while True:
        records.append(timed_solve(jax, solver))
        with jax.profiler.TraceAnnotation("bench.between"):
            if time.perf_counter() - t0 >= seconds:
                break
    return records, time.perf_counter() - t0


def traced_solve(jax, solver, trace_dir):
    """One solve under the profiler (its per-kernel cost slows the solve,
    so the end-to-end metrics never come from it)."""
    with jax.profiler.trace(trace_dir,
                            profiler_options=trace_mod.profile_options(jax)):
        return timed_solve(jax, solver, traced=True)


def rel_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def check(world, solver, records, traffic, limits):
    """Each number compared, worst over the window's solves, with its limit:
    the reference gradnorm at the final iterate against the stop rule, the
    program's own cost and gradnorm there against the reference's, and the
    rotation blocks' distance from the manifold."""
    worst = {"gradnorm": 0.0, "gradnorm_gap": 0.0, "cost_gap": 0.0,
             "off_manifold": 0.0}
    for rec in records:
        cost, gradnorm = reference.cost_and_gradnorm(world, rec["X"])
        dev_cost, dev_gradnorm = solver.device_metrics(rec)
        for key, value in (
            ("gradnorm", gradnorm),
            ("gradnorm_gap", rel_gap(dev_gradnorm, gradnorm)),
            ("cost_gap", rel_gap(dev_cost, cost)),
            ("off_manifold", reference.stiefel_error(rec["X"], world.d)),
        ):
            # a NaN fails every comparison: keep it as the worst
            if not value <= worst[key]:
                worst[key] = value
    bounds = dict(limits, gradnorm=float(traffic["tol"]))
    checks = {k: {"value": worst[k], "limit": bounds[k]} for k in worst}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def smi_summary(rows):
    """Name, power limit, and the range of SM clock and power draw."""
    if not rows:
        return None
    parts = [[p.strip() for p in r.split(",")] for r in rows]
    return {"samples": len(parts), "name": parts[0][0],
            "power_limit": parts[0][4], "sm_clock": sorted({p[1] for p in parts}),
            "power_draw_first_last": [parts[0][3], parts[-1][3]]}


def main(argv=None, *, spec_path=None, bench_dir=BENCH_DIR, root=ROOT,
         require_gpu=True, cache_dir="default"):
    args = parse_args(argv)
    keep_trace = args.keep_trace
    spec = load_json(spec_path or os.path.join(root, "BENCHMARK.json"))
    cell, config, traffic, loop, per_layer = resolve_cell(
        spec, args.workload, root=root, bench_dir=bench_dir)
    limits = load_json(os.path.join(bench_dir, "limits",
                                    args.workload + ".json"))

    import jax

    jax.config.update("jax_enable_x64", True)
    if require_gpu:
        devices = require_devices(jax, int(cell["chips"]))
    else:
        devices = jax.devices()[: int(cell["chips"])]
    if cache_dir == "default":
        cache_dir = os.path.join(root, ".jax_cache")
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    dev = devices[0]

    world = make_world(config)
    shuffled, lift = draw(world, int(config["r"]), args.seed)
    solver = loop.prepare(program_edges(shuffled), shuffled, config, traffic,
                          lift, dtype=config.get("dtype", "float64"))
    print(json.dumps({"cell": args.workload, **solver.counts}), flush=True)
    solver.warmup()

    trace_dir = None
    if args.trace:
        trace_dir = keep_trace or os.path.join(root, ".bench_trace")
        shutil.rmtree(trace_dir, ignore_errors=True)
    smi_rows = []
    with smi_sampler(smi_rows), CompileCounter(jax) as compiles:
        setup_s = time.perf_counter() - _T_START
        traced = [traced_solve(jax, solver, trace_dir)] if args.trace else []
        records, window_s = run_window(jax, solver, args.seconds)
    records = traced + records
    for row in smi_rows:
        print("nvidia-smi:", row, flush=True)
    print(json.dumps({
        "compilations_in_window": compiles.count,
        "smi": smi_summary(smi_rows),
        "solve_seconds": [r["seconds"] for r in records],
    }), flush=True)
    if compiles.count:
        raise BenchError(f"{compiles.count} compilations inside the window")

    stats = dev.memory_stats() or {}
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devices),
              "memory_peak_bytes": int(stats.get("peak_bytes_in_use", 0))}
    failed = sum(1 for r in records if r["capped"])
    result = {"correct": None, "attempted": len(records), "failed": failed}
    if args.trace:
        summary = trace_mod.summarize(trace_dir)
        if keep_trace is None:
            shutil.rmtree(trace_dir, ignore_errors=True)
        ctx = {"trace": summary, "solves": records}
        metrics = {}
        for m in per_layer:
            reader = load_module(os.path.join(bench_dir, "metrics"), m["name"])
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = summary["breakdown"]
    else:
        result["metrics"] = {
            "solve_s": {"value": window_s / len(records), "unit": "s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["device"] = device

    ok, checks = check(world, solver, records, traffic, limits)
    result["correct"] = ok
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} <= {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--keep-trace", metavar="DIR",
                   help="write the profiler trace to DIR and keep it")
    return p.parse_args(argv)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
