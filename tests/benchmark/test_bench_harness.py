"""The harness's command on a CPU, and what a later cell, traffic mix or
per-layer metric needs: new files and new entries, no edits."""

import hashlib
import json
import os
import subprocess
import sys

from benchmark import run as bench_run
from tests.benchmark import tiny


def test_command_exits_nonzero_on_a_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "grid3d-8k.central", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"],
        cwd=bench_run.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_cells_resolve_by_name():
    spec = bench_run.load_json(os.path.join(bench_run.ROOT, "BENCHMARK.json"))
    for cell in spec["workloads"]:
        _, config, traffic, loop, per_layer = bench_run.resolve_cell(
            spec, cell["name"])
        assert config["name"] == cell["config"]
        assert callable(loop.prepare)
        assert per_layer
        for m in per_layer:
            module = bench_run.load_module(
                os.path.join(bench_run.BENCH_DIR, "metrics"), m["name"])
            assert callable(module.read)
        assert os.path.isfile(os.path.join(
            bench_run.BENCH_DIR, "limits", cell["name"] + ".json"))


def tree_digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_new_files_only(tmp_path, capsys):
    tree = tiny.make_tree(tmp_path)
    before = tree_digest(tree.bench_dir)

    with open(os.path.join(tree.bench_dir, "configs", "dummy-grid.json"),
              "w") as f:
        json.dump(dict(tiny.CONFIGS["tiny-grid"], name="dummy-grid",
                       params={"num_poses": 64, "lc_fraction": 1.0,
                               "seed": 3}, poses=64, edges=147), f)
    with open(os.path.join(tree.bench_dir, "traffic", "central-loose.json"),
              "w") as f:
        json.dump({"kind": "central", "tol": 0.05, "initial_radius": 10.0,
                   "max_iterations": 20, "max_inner": 50}, f)
    with open(os.path.join(tree.bench_dir, "metrics", "rtr_iters.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    return sum(r['rtr_iters'] for r in ctx['solves'])\n")
    cell = "dummy-grid.central-loose"
    with open(os.path.join(tree.bench_dir, "limits", cell + ".json"),
              "w") as f:
        json.dump({"gradnorm_gap": 1e-6, "cost_gap": 1e-6,
                   "off_manifold": 1e-6}, f)
    spec = tiny.read_spec(tree)
    spec["configs"].append({"name": "dummy-grid", "source": "test",
                            "file": "benchmark/configs/dummy-grid.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "dummy-grid",
                              "traffic": "central-loose", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "rtr_iters", "unit": "count",
                              "better": "lower", "source": "program_counter",
                              "layer": "local solve", "moves": "solve_s",
                              "workloads": [cell]})
    tiny.write_spec(tree.spec_path, spec)

    after = tree_digest(tree.bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before

    result = tiny.run(tree, cell, capsys, trace=1)
    assert result["correct"] is True
    assert result["metrics"]["rtr_iters"]["value"] >= 1
    assert result["metrics"]["rtr_iters"]["unit"] == "count"
    # the cell reports only what lists it: no RBCD round counter here
    assert "rounds_per_solve" not in result["metrics"]
    assert list(result)[-1] == "checks"
