"""The trace reduction, on a trace recorded on an H100 and on made-up
events whose answer is plain."""

import os

import pytest

from benchmark import trace
from benchmark.run import BENCH_DIR
from benchmark.trace import Event

TESTDATA = os.path.join(BENCH_DIR, "testdata")


def test_recorded_trace_reduces_to_the_numbers_read_by_hand():
    """One solve of a 125-pose grid world through the `central` loop on an
    NVIDIA H100 80GB HBM3 (700 W limit). Read by hand from the file:
    `bench.solve` opens at 18,821,843 ns and `bench.readback` closes at
    93,713,148 + 1,942,953 ns; the device plane has 5,828 events with
    kernel details and 162 `MemcpyD2H` events (154 one-byte loop predicates
    on the compute stream, 8 result copies); its stream lines are busy
    10.203661 + 0.036572 + 0.005023 + 0.004544 + 0.004640 + 0.004576 ms,
    with no overlap between them."""
    s = trace.summarize(TESTDATA)
    assert s["solves"] == 1
    assert s["devices"] == 1
    assert s["window_s"] == pytest.approx(
        (93_713_148 + 1_942_953 - 18_821_843) / 1e9, abs=1e-12)
    assert s["busy_s"] == pytest.approx(10.259016e-3, abs=1e-9)
    assert s["kernels"] == 5828
    assert s["memcpy_d2h"] == 162
    ops = dict(s["breakdown"]["device_ops"])
    assert len(ops) == trace.TOP
    assert ops["MemcpyD2H"] == pytest.approx(0.000373887, abs=1e-12)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "bench.solve: householder_product.2 x3375"
    # idle is the window less busy, split over the labels
    assert sum(v for _, v in gaps) <= s["window_s"] - s["busy_s"] + 1e-12


def test_union_gaps_and_labels():
    host = [
        Event("bench.solve", 0, 100),
        Event("PjitFunction(step)", 5, 60),
        Event("kern_a", 10, 11),  # a launch: named as its kernel
        Event("bench.readback", 100, 200),
        Event("np.asarray(jax.Array)", 101, 199),
        Event("bench.between", 200, 210),
    ]
    device = {"/device:GPU:0": [
        Event("kern_a", 20, 40, "kernel"),
        Event("kern_b", 30, 50, "kernel"),  # overlaps kern_a
        Event("MemcpyD2H", 150, 160, "memcpy_d2h"),
        Event("kern_c", 250, 260, "kernel"),  # after the window
    ]}
    s = trace.summarize_events(host, device)
    assert s["window_s"] == 200e-9
    assert s["busy_s"] == 40e-9  # [20, 50) and [150, 160)
    assert s["kernels"] == 2 and s["memcpy_d2h"] == 1
    # gaps [0, 20), [50, 150), [160, 200), each named at its start; the
    # launch event kern_a is skipped, PjitFunction(step) is still open at 50
    assert s["breakdown"]["idle_gaps"] == [
        ["bench.solve: PjitFunction(step) x1", 100e-9],
        ["bench.readback: np.asarray(jax.Array) x1", 40e-9],
        ["bench.solve x1", 20e-9],
    ]
