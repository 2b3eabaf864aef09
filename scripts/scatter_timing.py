#!/usr/bin/env python
"""Time the gather-path scatter-add of q_matvec two ways on the current
device, against a device-to-device copy timed in the same run.

    python scripts/scatter_timing.py [reps]

Worlds: city2d-10k (5 agents) and city2d-100k (10 agents), r=3, so a row is
r*(d+1) = 9 values. The edges are the SPMD problem's private edges outside
the band lanes (the gather path), padded per agent as the engine holds them.
Forms, each vmapped over agents like the engine's round:

  scatter     out.at[j].add(c)            (edge order, as q_matvec does)
  segment_sum jax.ops.segment_sum(c, j, indices_are_sorted=True) on data
              pre-sorted by destination (the sort is done once, untimed)

Each form runs `reps` times inside one jitted program, each repetition
depending on the last, so per-rep time = program time / reps. Bytes per rep
count the contributions and indices read plus the output read and written.
Prints one JSON line per (world, dtype) and one for the copy.
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np

import jax
import jax.numpy as jnp

import dpgo_tpu  # noqa: F401  (enables x64)
from dpgo_tpu.datasets import synthesize_city2d
from dpgo_tpu.parallel import spmd

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 50
WORLDS = ((10_000, 5), (100_000, 10))
R = 3


def best_seconds(fn, *args, calls=5):
    jax.block_until_ready(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def chained(step, reps):
    """One program applying `step` reps times, each rep on the last's
    output behind an optimization barrier, so XLA can neither hoist, merge
    nor fuse the repetitions."""
    def run(out, c):
        for _ in range(reps):
            out = jax.lax.optimization_barrier(step(out, c))
        return out
    return jax.jit(run)


def copy_gbps():
    x = jnp.ones((1 << 27,), jnp.float32)  # 512 MiB
    f = chained(lambda y, _c: y + 1.0, REPS)
    t = best_seconds(f, x, None) / REPS
    return 2 * x.size * 4 / t / 1e9, t


def world_arrays(num_poses, agents):
    edges, n, _ = synthesize_city2d(num_poses, seed=1)
    problem, _ = spmd.build_spmd_problem(edges.to_measurements(), n, agents, R)
    nb = problem.num_band
    j = np.asarray(problem.priv_j)[:, nb:]
    real = int(np.sum(np.asarray(problem.priv_weight)[:, nb:] > 0))
    return problem.n_max, j, real


def time_forms(n_max, j, dtype):
    A, m = j.shape
    w = R * 3
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.standard_normal((A, m, w)), dtype)
    order = np.argsort(j, axis=1, kind="stable")
    j_sorted = np.take_along_axis(j, order, axis=1)
    c_sorted = jnp.take_along_axis(c, jnp.asarray(order)[:, :, None], axis=1)
    out0 = jnp.zeros((A, n_max, w), dtype)
    j_dev = jnp.asarray(j, jnp.int32)
    js_dev = jnp.asarray(j_sorted, jnp.int32)

    def scatter(out, cc):
        return jax.vmap(lambda o, idx, x: o.at[idx].add(x))(out, j_dev, cc)

    def segsum(out, cc):
        return out + jax.vmap(
            lambda idx, x: jax.ops.segment_sum(
                x, idx, num_segments=n_max, indices_are_sorted=True
            )
        )(js_dev, cc)

    itemsize = jnp.dtype(dtype).itemsize
    nbytes = A * m * (w * itemsize + 4) + 2 * A * n_max * w * itemsize
    # the two forms must agree (same sums, other order)
    a = chained(scatter, 1)(out0, c)
    b = chained(segsum, 1)(out0, c_sorted)
    tol = 1e-9 if dtype == jnp.float64 else 1e-3
    err = float(jnp.max(jnp.abs(a - b)))
    assert err <= tol, err
    res = {}
    for name, step, cc in (("scatter", scatter, c),
                           ("segment_sum_sorted", segsum, c_sorted)):
        t = best_seconds(chained(step, REPS), out0, cc) / REPS
        res[name + "_us"] = t * 1e6
        res[name + "_gbps"] = nbytes / t / 1e9
    res["bytes_per_rep"] = nbytes
    return res


def main():
    dev = jax.devices()[0]
    gbps, t = copy_gbps()
    print(json.dumps({"device": dev.device_kind, "copy_gbps": gbps,
                      "copy_512MiB_us": t * 1e6}), flush=True)
    for num_poses, agents in WORLDS:
        n_max, j, real = world_arrays(num_poses, agents)
        for dtype in (jnp.float64, jnp.float32):
            rec = {"world": f"city2d-{num_poses // 1000}k", "agents": agents,
                   "row_width": R * 3, "dtype": jnp.dtype(dtype).name,
                   "gather_path_edges": real,
                   "padded_edges": int(j.size), "rows": agents * n_max}
            rec.update(time_forms(n_max, j, dtype))
            rec["scatter_share_of_copy"] = rec["scatter_gbps"] / gbps
            rec["segment_sum_share_of_copy"] = (
                rec["segment_sum_sorted_gbps"] / gbps)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
