"""A copy of the benchmark with small cells, for runs on the CPU.

`make_tree(dst)` copies `benchmark/` under `dst`, adds two small
configurations that run the real solve loops and the real cells' limits,
and writes `dst/BENCHMARK.json` naming them. `run(tree, workload, ...)`
drives the harness's `main` on that tree without its look for a GPU and
returns the result line as a dict.
"""

import json
import os
import shutil
from typing import NamedTuple

from benchmark import run as bench_run

CELLS = {
    # tiny cell: (config, traffic, real cell whose limits it is held to)
    "tiny-city.rbcd": ("tiny-city", "rbcd", "city2d-10k.rbcd5"),
    "tiny-grid.central": ("tiny-grid", "central", "grid3d-8k.central"),
}

CELLS_BY_REAL = {real: tiny for tiny, (_, _, real) in CELLS.items()}

CONFIGS = {
    "tiny-city": {
        "generator": "synthesize_city2d",
        "params": {"num_poses": 400, "seed": 1},
        "poses": 400, "edges": 729, "d": 2, "r": 5, "agents": 2,
        "dtype": "float64",
    },
    "tiny-grid": {
        "generator": "synthesize_grid3d",
        "params": {"num_poses": 125, "lc_fraction": 1.0, "seed": 1},
        "poses": 125, "edges": 304, "d": 3, "r": 5, "agents": 1,
        "dtype": "float64",
    },
}


class Tree(NamedTuple):
    root: str
    bench_dir: str
    spec_path: str


def make_tree(dst):
    root = str(dst)
    bench_dir = os.path.join(root, "benchmark")
    shutil.copytree(bench_run.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = []
    for name, cfg in CONFIGS.items():
        rel = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, rel), "w") as f:
            json.dump(dict(cfg, name=name), f)
        spec["configs"].append({"name": name, "source": "test", "file": rel,
                                "reduced": [], "why": "test"})
    spec["workloads"] = []
    for name, (config, traffic, real) in CELLS.items():
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
        shutil.copy(os.path.join(bench_dir, "limits", real + ".json"),
                    os.path.join(bench_dir, "limits", name + ".json"))
    for m in spec["per_layer"]:
        m["workloads"] = [CELLS_BY_REAL.get(w, w) for w in m["workloads"]]
    spec_path = os.path.join(root, "BENCHMARK.json")
    write_spec(spec_path, spec)
    return Tree(root, bench_dir, spec_path)


def read_spec(tree):
    with open(tree.spec_path) as f:
        return json.load(f)


def write_spec(path, spec):
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)


def run(tree, workload, capsys, seed=5, seconds=0.0, trace=0):
    """One run of a tiny cell on the CPU; the parsed result line."""
    argv = ["--workload", workload, "--seed", str(seed),
            "--seconds", str(seconds), "--trace", str(trace)]
    code = bench_run.main(argv, spec_path=tree.spec_path,
                          bench_dir=tree.bench_dir, root=tree.root,
                          require_gpu=False, cache_dir=None)
    assert code == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
