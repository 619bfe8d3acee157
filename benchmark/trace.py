"""Reading a ``torch.profiler`` Chrome trace: device intervals, the device
time of the kernels each benchmark range launched, and the breakdown.

A kernel belongs to the range (a ``record_function`` annotation on the
host) in which the host call that launched it ran: the kernel's
``correlation`` names that call.  Nothing here matches a kernel's name; names
only label the breakdown.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

__all__ = ["load", "device_events", "merged", "busy_us", "by_range",
           "kernel_count", "breakdown"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def device_events(events) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def kernel_count(events) -> int:
    return sum(1 for e in events if e.get("cat") == "kernel")


def merged(intervals) -> list:
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events, t0: float, t1: float) -> float:
    """Microseconds in [t0, t1] in which some operation ran on the device."""
    total = 0.0
    for s, e in merged((ev["ts"], ev["ts"] + ev["dur"])
                       for ev in device_events(events)):
        total += max(0.0, min(e, t1) - max(s, t0))
    return total


def _ranges(events, prefix):
    """Per host thread, the ranges named ``prefix``…, sorted by start."""
    out = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(prefix):
            out[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    for v in out.values():
        v.sort()
    return out


def by_range(events, prefix: str = "bench."):
    """{range name: (device µs, kernels)} of the device operations whose
    launching host call ran inside a range named ``prefix``… (the innermost
    one, where they nest)."""
    ranges = _ranges(events, prefix)
    starts = {k: [r[0] for r in v] for k, v in ranges.items()}
    owner = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        key = (e.get("pid"), e.get("tid"))
        if corr is None or key not in ranges:
            continue
        i = bisect.bisect_right(starts[key], e["ts"]) - 1
        while i >= 0:
            s, end, name = ranges[key][i]
            if s <= e["ts"] <= end:
                owner[corr] = name
                break
            i -= 1
    out = defaultdict(lambda: [0.0, 0])
    for e in device_events(events):
        name = owner.get(e.get("args", {}).get("correlation"))
        if name is not None:
            out[name][0] += e["dur"]
            out[name][1] += e.get("cat") == "kernel"
    return {k: tuple(v) for k, v in out.items()}


def breakdown(events, t0: float, t1: float, top: int = 10) -> dict:
    """The device operations with the most time in [t0, t1], and the idle
    gaps there by what the host was doing (the innermost host event over a
    gap's middle), each in seconds, at most ``top`` of each."""
    ops = defaultdict(float)
    dev = [e for e in device_events(events)
           if e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    for e in dev:
        ops[e["name"]] += e["dur"] * 1e-6
    gaps = []
    edge = t0
    for s, e in merged((ev["ts"], ev["ts"] + ev["dur"]) for ev in dev):
        if s > edge:
            gaps.append((edge, min(s, t1)))
        edge = max(edge, e)
    if edge < t1:
        gaps.append((edge, t1))
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    host_starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(host_starts, mid)
        inner = None
        for hs, he, name in host[max(0, i - 2000):i]:
            if hs <= mid <= he and (inner is None or he - hs < inner[0]):
                inner = (he - hs, name)
        idle[inner[1] if inner else "no host event"] += (e - s) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
