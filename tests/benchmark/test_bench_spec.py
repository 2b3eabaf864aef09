"""BENCHMARK.json keeps to the shape its readers expect."""

import json
import os
import re

import pytest

from benchmark.run import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", *KEYS}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    for path in SPEC["paths"]:
        assert os.path.isdir(os.path.join(ROOT, path))


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(set(names)) == len(names)
    for e in SPEC[section]:
        assert set(e) - {"workloads"} == KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_references_resolve():
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(
            BENCH_DIR, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_peaks_by_device_kind():
    from benchmark import peaks

    h100 = peaks.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["flops_per_s"]["float64"] == 34e12 and h100["source"]
    with pytest.raises(KeyError, match="no published peaks"):
        peaks.device_peaks("cpu")
