"""`correct` on the small tiny-grid cell (the real cell's limits): true for
the program as it is, false for its float32 path (the control) and for
each fault that a cell of this kind can have."""

import json
import os

import pytest

from tests.benchmark import faults, tiny

CELL = "tiny-grid.central"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def test_sound_run_is_correct(tree, capsys):
    result = tiny.run(tree, CELL, capsys, seed=2**40 + 3)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0


def test_float32_control_is_not_correct(tmp_path, capsys):
    tree = tiny.make_tree(tmp_path)
    path = os.path.join(tree.bench_dir, "configs", "tiny-grid.json")
    with open(path) as f:
        config = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(config, dtype="float32"), f)
    result = tiny.run(tree, CELL, capsys)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS[CELL]))
def test_fault_is_not_correct(tree, capsys, monkeypatch, fault):
    faults.FAULTS[CELL][fault](monkeypatch)
    result = tiny.run(tree, CELL, capsys)
    assert result["correct"] is False, result["checks"]
