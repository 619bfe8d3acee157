"""The card a measurement names (``nvidia-smi``'s name and power limit) and
the device time of a call: under ``torch.profiler``, or, where the profiler
records no device event, by CUDA events around a captured graph of the
calls."""
from __future__ import annotations

import subprocess
import sys

__all__ = ["nvidia_smi_name_power", "device_ms", "profiler_ms",
           "graph_event_ms", "stream_event_ms"]


def profiler_ms(fn, reps: int = 20, with_cpu: bool = False, kernels=None):
    """The profiler's device time summed over every kernel that ``reps``
    calls launched, per call; None if the profile holds no device event,
    or, given ``kernels`` = (name, n), where it does not hold n kernels a
    call whose names contain ``name`` (it lost some)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if with_cpu:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if kernels is not None:
        name, n = kernels
        if sum(e.count for e in events if name in e.key) != n * reps:
            return None
    return us / 1e3 / reps if us > 0 else None


def graph_event_ms(fn, reps: int = 20) -> float:
    """Time per call by CUDA events around one replay of a graph that holds
    ``reps`` calls: the kernels run back to back with no host in between, so
    this is the device time plus the graph's gaps between kernel nodes.
    Raises if a call cannot be captured (it synchronises, say)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def stream_event_ms(fn, reps: int = 20) -> float:
    """Time per call by CUDA events around ``reps`` calls on the current
    stream: includes the gaps in which the host is still enqueuing."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a profile reading under this share of the events' time lost device
# events: the graph's gaps between kernel nodes are a microsecond or two,
# far from doubling any call's time, while a profile that lost events read
# 0.1 and 0.36 of it on an H100
LOST = 0.5


def _checked(fn, ms: float, reps: int) -> float:
    """The profiler's ``ms``, unless it lost device events: a profile can
    come back with some of the calls' kernels missing (read on an H100,
    later in a process that had profiled many times: K1's apply at 4.1 µs
    and at 14.5 µs, where it takes 41 µs).  A profile that reads under
    :data:`LOST` of the time by CUDA events around a quarter as many calls
    is checked against the events around a replayed graph of ``reps``
    calls (no host gaps); under :data:`LOST` of that too, the graph's time
    is returned and a line on the standard error says so."""
    import torch

    if ms >= stream_event_ms(fn, max(1, reps // 4)) * LOST:
        return ms
    try:
        ev = graph_event_ms(fn, reps)
    except Exception:                         # the call is not capturable
        torch.cuda.synchronize()
        return ms
    if ms >= ev * LOST:
        return ms
    print(f"[device_ms] the profiler read {ms:.4f} ms per call, under "
          f"{LOST:g} of {ev:.4f} ms by CUDA events around a replayed graph "
          f"of the calls: it lost device events; the graph's time is used",
          file=sys.stderr, flush=True)
    return ev


def device_ms(fn, reps: int = 20, kernels=None) -> float:
    """Kernel time per call on the card, mean of ``reps`` calls after one
    warm-up call: the profiler's device time, held against CUDA events
    (:func:`_checked`).  A profile can come back without device events,
    and then the next ones often do too, so after three such profiles the
    time is taken by CUDA events instead, around a replayed graph of the
    calls, or around the plain calls where they cannot be captured; a line
    on the standard error says so.  ``kernels`` = (name, n): each call
    launches n kernels whose names contain ``name``, and a profile that
    holds another count of them lost some and counts as one without
    device events (a call of several kernels that lost one can read well
    above :data:`LOST` of its time)."""
    import torch

    fn()
    for attempt in range(3):
        ms = profiler_ms(fn, reps, with_cpu=attempt == 2, kernels=kernels)
        if ms is not None:
            return _checked(fn, ms, reps)
    try:
        ms, how = graph_event_ms(fn, reps), "a replayed graph of the calls"
    except Exception as exc:                  # the call is not capturable
        torch.cuda.synchronize()
        ms = stream_event_ms(fn, reps)
        how = f"the calls on the stream (no graph: {type(exc).__name__})"
    lost = "" if kernels is None else (
        f" or not {kernels[1]} {kernels[0]} kernels a call")
    print(f"[device_ms] the profiler recorded no device time{lost}; "
          f"{ms:.4f} ms per call is by CUDA events around {how}",
          file=sys.stderr, flush=True)
    return ms


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
