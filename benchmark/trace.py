"""Reduce one `jax.profiler` trace to the numbers the per-layer metrics read.

The harness wraps each phase of its window in a `TraceAnnotation`:
`bench.solve` (the call into the program), `bench.readback` (waiting for
the result to reach the host) and `bench.between` (its own bookkeeping).
The traced window runs from the start of the first `bench.solve` to the end
of the last `bench.readback`.

On the device planes (`/device:GPU:<k>`), every event on a stream line is
one operation the card ran: a kernel, a copy or a memset. Busy time is the
union of their intervals inside the window, averaged over the devices;
idle is the rest. Idle time is summed by what the host thread was doing
when each gap began: the harness annotation it was inside and the
innermost host event then open there, kernel launches aside (a jitted
call, an XLA thunk, a transfer, a wait).
"""

from __future__ import annotations

import collections
import glob
import gzip
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

ANNOTATIONS = ("bench.solve", "bench.readback", "bench.between")
DEVICE_PREFIX = "/device:GPU:"
TOP = 10


class Event(NamedTuple):
    name: str
    start: int  # ns
    end: int  # ns
    kind: str = ""  # device: "kernel", "memcpy_d2h", "memcpy", "memset", "other"


def profile_options(jax):
    """Host and device tracing without the Python function tracer, whose
    per-call events slow the host and swell the file."""
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.enable_hlo_proto = False
    return opts


def device_kind(name: str, stats: Dict[str, object]) -> str:
    """Classify one event of a device stream line by its stats: kernels
    carry `kernel_details`, copies `memcpy_details` (source and
    destination memory kinds)."""
    if "kernel_details" in stats:
        return "kernel"
    details = str(stats.get("memcpy_details", ""))
    if "memset" in name.lower():
        return "memset"
    if details or name.startswith("Memcpy"):
        if name == "MemcpyD2H" or (
                "kind_src:device" in details
                and "kind_dst:device" not in details):
            return "memcpy_d2h"
        return "memcpy"
    return "other"


def load_profiles(trace_dir: str):
    """Every `.xplane.pb` (or gzipped `.xplane.pb.gz`) under trace_dir."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb*"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    for path in paths:
        if path.endswith(".gz"):
            with gzip.open(path, "rb") as f:
                yield ProfileData.from_serialized_xspace(f.read())
        else:
            yield ProfileData.from_file(path)


def read_xplane(trace_dir: str):
    """(host events by thread line, device events by device plane)."""
    host: Dict[str, List[Event]] = {}
    device: Dict[str, List[Event]] = {}
    for data in load_profiles(trace_dir):
        for plane in data.planes:
            if plane.name.startswith(DEVICE_PREFIX):
                evs = device.setdefault(plane.name, [])
                for line in plane.lines:
                    if not line.name.startswith("Stream"):
                        continue
                    for e in line.events:
                        stats = dict(e.stats)
                        evs.append(Event(
                            e.name, int(e.start_ns),
                            int(e.start_ns + e.duration_ns),
                            device_kind(e.name, stats)))
            elif plane.name.startswith("/host:"):
                for line in plane.lines:
                    host[f"{plane.name}/{line.name}"] = [
                        Event(e.name, int(e.start_ns),
                              int(e.start_ns + e.duration_ns))
                        for e in line.events]
    return host, device


def union_length(intervals: Sequence[Tuple[int, int]]) -> Tuple[int, list]:
    """Total length of a union of [start, end) intervals, and the union."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def annotation_thread(host: Dict[str, List[Event]]) -> Optional[str]:
    for key, evs in host.items():
        if any(e.name == "bench.solve" for e in evs):
            return key
    return None


def label_gaps(host_events: List[Event], gaps: List[Tuple[int, int]],
               launches: set) -> List[Tuple[str, Tuple[int, int]]]:
    """Idle time by what the host thread was doing when each gap began:
    (label, (idle ns, gaps)), most idle first. The label is the harness
    annotation then open and the innermost host event inside it, skipping
    kernel-launch events (named as the kernel they launch)."""
    events = sorted((e for e in host_events if e.name not in launches),
                    key=lambda e: (e.start, -e.end))
    totals: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    stack: List[Event] = []
    k = 0
    for s, t in sorted(gaps):
        while k < len(events) and events[k].start <= s:
            while stack and stack[-1].end <= events[k].start:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1].end <= s:
            stack.pop()
        phase = next((e.name for e in stack if e.name in ANNOTATIONS),
                     "outside")
        inner = stack[-1].name if stack else phase
        label = phase if inner == phase else f"{phase}: {inner}"
        totals[label][0] += t - s
        totals[label][1] += 1
    return sorted(((k_, tuple(v)) for k_, v in totals.items()),
                  key=lambda kv: -kv[1][0])


def summarize_events(host_events: List[Event],
                     device: Dict[str, List[Event]]) -> dict:
    """The reduction itself, on events already read from the trace.

    host_events: the events of the thread that ran the harness's window.
    device: each device plane's stream events.
    """
    marks = sorted((e for e in host_events if e.name in ANNOTATIONS),
                   key=lambda e: e.start)
    solves = [e for e in marks if e.name == "bench.solve"]
    if not solves:
        raise ValueError("the trace holds no bench.solve annotation")
    w0 = solves[0].start
    w1 = max(e.end for e in marks if e.name == "bench.readback")
    window = w1 - w0

    busy_by_device = []
    kinds: Dict[str, int] = collections.Counter()
    per_op: Dict[str, int] = collections.defaultdict(int)
    gaps: List[Tuple[int, int]] = []
    for name in sorted(device):
        clipped = []
        for e in device[name]:
            if e.end < w0 or e.start >= w1:
                continue
            s, t = max(e.start, w0), min(e.end, w1)
            clipped.append((s, t))
            per_op[e.name] += t - s
            kinds[e.kind] += 1
        busy, merged = union_length(clipped)
        busy_by_device.append(busy)
        prev = w0
        for s, t in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if w1 > prev:
            gaps.append((prev, w1))
    n_dev = max(len(busy_by_device), 1)
    busy = sum(busy_by_device) / n_dev

    idle = label_gaps(host_events, gaps, launches=set(per_op))
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "solves": len(solves),
        "window_s": window / 1e9,
        "busy_s": busy / 1e9,
        "devices": len(busy_by_device),
        "kernels": kinds["kernel"] / n_dev,
        "memcpy_d2h": kinds["memcpy_d2h"] / n_dev,
        "breakdown": {
            "device_ops": [[name, ns / 1e9] for name, ns in top_ops],
            "idle_gaps": [[f"{label} x{count}", ns / 1e9]
                          for label, (ns, count) in idle[:TOP]],
        },
    }


def summarize(trace_dir: str) -> dict:
    host, device = read_xplane(trace_dir)
    thread = annotation_thread(host)
    if thread is None:
        raise ValueError(f"no bench.solve annotation in {trace_dir}")
    return summarize_events(host[thread], device)
