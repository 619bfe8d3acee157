#!/usr/bin/env python3
"""The program's own spans (``poms_tpu_torch/utils/trace.py``) read from a
``torch.profiler`` trace, and a command that takes them for one cell:

    python3 benchmark/spans.py --workload <cell> --seed <n>

It builds the cell as ``run.py`` does (``harness.build``, by the kinds its
configuration names), with a recording over set-up, then profiles a few
eager steps and a few whole replayed solves with a recording over each, and
prints one JSON line: set-up by span, the plans' scratch, the cycle's
levels, K6r and K6u per call, and the replayed solves' idle time split into
the gaps between graph replays, the eager starts and the rest by name.  No
metric of ``BENCHMARK.json`` reads this yet (the harness takes no
recording); its functions are what such readers need.

A record joins the trace by occurrence: the k-th ``poms.*`` range of a name,
by start, is the k-th record of that name.  A trace with fewer ranges of a
name than the recording has records is refused (:class:`IncompleteTrace`),
as the harness refuses a profile that lost kernels.  A device operation
belongs to every range that holds, on the same host thread, the call that
launched it (named by its ``correlation``; a graph replay's kernels carry
that of its ``cudaGraphLaunch``).  Times are µs on the trace's clock.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import trace as tr  # noqa: E402

__all__ = ["IncompleteTrace", "join", "owned", "replay_gaps",
           "start_intervals", "level_device_us", "coarse_share",
           "setup_seconds", "idle_split", "main"]

PREFIX = "poms."
REPLAY = "poms.graph.replay"
LEVEL = "poms.cycle.L"
COARSE = "poms.cycle.coarse"


class IncompleteTrace(RuntimeError):
    """The trace holds fewer program ranges, or fewer operations of a
    replay, than the program recorded."""


def join(events, records) -> list:
    """``[(record, (start, end, thread))]``: each record with its range."""
    ranges = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith(PREFIX):
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"],
                                      (e.get("pid"), e.get("tid"))))
    for v in ranges.values():
        v.sort()
    wanted = Counter(r.name for r in records)
    short = {n: (len(ranges.get(n, ())), k) for n, k in wanted.items()
             if len(ranges.get(n, ())) < k}
    if short:
        raise IncompleteTrace(
            "the trace holds fewer ranges than the recording has records "
            "(ranges, records): " + ", ".join(f"{n} {v}" for n, v in
                                              sorted(short.items())))
    seen = Counter()
    out = []
    for r in records:
        out.append((r, ranges[r.name][seen[r.name]]))
        seen[r.name] += 1
    return out


def owned(events, joined) -> dict:
    """{record id: [device operations]}: the operations launched inside each
    record's range."""
    by_thread = defaultdict(list)
    for r, (s, e, thread) in joined:
        by_thread[thread].append((s, e, r.id))
    for v in by_thread.values():
        v.sort()
    starts = {k: [x[0] for x in v] for k, v in by_thread.items()}
    holders = {}
    for e in events:
        if e.get("cat") not in tr.LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        thread = (e.get("pid"), e.get("tid"))
        if corr is None or thread not in by_thread:
            continue
        ts, spans = e["ts"], by_thread[thread]
        holders[corr] = [rid for s, end, rid
                         in spans[:bisect.bisect_right(starts[thread], ts)]
                         if s <= ts <= end]
    out = defaultdict(list)
    for op in tr.device_events(events):
        for rid in holders.get(op.get("args", {}).get("correlation"), ()):
            out[rid].append(op)
    return out


def _span(ops):
    return (min(op["ts"] for op in ops),
            max(op["ts"] + op["dur"] for op in ops))


def _replays(joined, ops):
    """{solve id: [(first op start, last op end)]} of each solve's graph
    replays, in order."""
    out = defaultdict(list)
    for r, _ in joined:
        if r.name == REPLAY:
            if not ops.get(r.id):
                raise IncompleteTrace(
                    f"graph replay record {r.id} owns no device operation")
            out[r.solve].append(_span(ops[r.id]))
    return out


def replay_gaps(joined, ops) -> list:
    """The device's idle time between consecutive graph replays of one
    solve: from the last operation of replay i to the first of replay
    i + 1, negative read as 0, over every solve."""
    return [max(0.0, nxt[0] - cur[1])
            for reps in _replays(joined, ops).values()
            for cur, nxt in zip(reps, reps[1:])]


def _starts(joined, ops) -> list:
    """(start of ``poms.solve``, first operation of its first replay) of each
    solve that replayed a graph."""
    reps = _replays(joined, ops)
    return [(rng[0], reps[r.id][0][0]) for r, rng in joined
            if r.name == "poms.solve" and r.solve == r.id and reps.get(r.id)]


def start_intervals(joined, ops) -> list:
    """Per solve, from the start of ``poms.solve`` to the first device
    operation of its first replay: the eager start state."""
    return [b - a for a, b in _starts(joined, ops)]


def level_device_us(joined, ops) -> dict:
    """{span name: (device µs of the operations under its ranges, ranges)}
    for the cycle's levels and the coarse solve."""
    out = {}
    for name in sorted({r.name for r, _ in joined
                        if r.name.startswith(LEVEL) or r.name == COARSE}):
        rids = [r.id for r, _ in joined if r.name == name]
        uniq = {id(op): op for rid in rids for op in ops.get(rid, ())}
        out[name] = (sum(op["dur"] for op in uniq.values()), len(rids))
    return out


def coarse_share(joined, ops):
    """Percent: device time of the operations under ``poms.cycle.L1``… or
    ``poms.cycle.coarse`` over that under ``poms.cycle.L0``; None without
    a level-0 range."""
    below, top = {}, {}
    for r, _ in joined:
        if r.name == LEVEL + "0":
            top.update((id(op), op) for op in ops.get(r.id, ()))
        elif r.name.startswith(LEVEL) or r.name == COARSE:
            below.update((id(op), op) for op in ops.get(r.id, ()))
    whole = sum(op["dur"] for op in top.values())
    if whole <= 0:
        return None
    return 100.0 * sum(op["dur"] for op in below.values()) / whole


def setup_seconds(records, name: str) -> float:
    """Σ of the host-clock durations of the records named ``name``."""
    return sum(r.seconds for r in records if r.name == name)


def _cut(piece, cover):
    """The parts of the interval ``piece`` outside the sorted, disjoint
    intervals ``cover``."""
    s, e = piece
    out = []
    for cs, ce in cover:
        if ce <= s or cs >= e:
            continue
        if cs > s:
            out.append((s, cs))
        s = max(s, ce)
    if s < e:
        out.append((s, e))
    return out


def _overlap(piece, cover) -> float:
    return sum(max(0.0, min(piece[1], ce) - max(piece[0], cs))
               for cs, ce in cover)


def idle_split(events, joined, ops, t0: float, t1: float) -> dict:
    """The device's idle µs in [t0, t1], split into the gaps between graph
    replays of one solve, the eager starts (idle only), the window's edges
    (outside both, before its first device operation or after its last) and
    the rest, each part named by the innermost host event over its middle
    (as the harness's breakdown names its gaps)."""
    busy = tr.merged((op["ts"], op["ts"] + op["dur"])
                     for op in tr.device_events(events)
                     if op["ts"] < t1 and op["ts"] + op["dur"] > t0)
    idle, edge = [], t0
    for s, e in busy:
        if s > edge:
            idle.append((edge, min(s, t1)))
        edge = max(edge, e)
    if edge < t1:
        idle.append((edge, t1))
    reps = _replays(joined, ops)
    gaps = sorted((cur[1], nxt[0]) for v in reps.values()
                  for cur, nxt in zip(v, v[1:]) if nxt[0] > cur[1])
    starts = sorted(_starts(joined, ops))
    cover = tr.merged(gaps + starts)
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in tr.HOST_CATS), key=lambda h: h[0])
    host_starts = [h[0] for h in host]
    rest, edges = defaultdict(float), 0.0
    for piece in idle:
        for s, e in _cut(piece, cover):
            if s == t0 or e == t1:
                edges += e - s
                continue
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(host_starts, mid)
            inner = None
            for hs, he, name in host[max(0, i - 2000):i]:
                if hs <= mid <= he and (inner is None
                                        or he - hs < inner[0]):
                    inner = (he - hs, name)
            rest[inner[1] if inner else "no host event"] += e - s
    return {"idle_us": sum(e - s for s, e in idle),
            "replay_gaps_us": sum(_overlap(p, gaps) for p in idle),
            "starts_us": sum(_overlap(p, starts) for p in idle),
            "edges_us": edges,
            "rest_us": dict(sorted(rest.items(), key=lambda kv: -kv[1]))}


# -- the command ----------------------------------------------------------------

def _recorded(fn):
    from poms_tpu_torch.utils import trace

    def run():
        with trace.recording() as records:
            out = fn()
        return out, records
    return run


def _replayed(solver, pool, tol, maxiter, n, tmp, device):
    """``n`` whole solves under the profiler and a recording, timed by CUDA
    events as the harness's replayed phase."""
    from torch.profiler import record_function
    import torch

    def solves():
        with record_function("bench.window"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            its = 0
            for i in range(n):
                its += solver.solve_compiled(pool[i % len(pool)], tol=tol,
                                             maxiter=maxiter,
                                             return_x=False)[2]
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3, its

    from benchmark.harness import _profile
    return _profile(_recorded(solves), tmp / "replayed.json", device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--solves", type=int, default=8)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cache = root / "_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    from benchmark import harness
    from poms_tpu_torch.ops import counters
    from poms_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("spans.py reads a card's trace: no CUDA device",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    man = harness.manifest(root)
    _, config, traffic = harness.cell(man, args.workload, root)
    kind = harness.kinds(config, root)
    times = {}
    with trace.recording() as setup:
        _, solver, pool = harness.build(config, kind, traffic, args.seed,
                                        device, times)
    scratch = counters.snapshot()["kron.scratch_bytes"]
    tol, maxiter = config["tol"], config["maxiter"]
    solver.solve_compiled(pool[0], tol=tol, maxiter=maxiter, return_x=False)
    torch.cuda.synchronize()
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device),
           "setup_s": {"problem": times["problem"],
                       "solver": times["solver"],
                       "hierarchy": setup_seconds(setup,
                                                  "poms.setup.hierarchy"),
                       "lambda": setup_seconds(setup, "poms.setup.lambda")},
           "scratch_gib": scratch / 2 ** 30}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        before = counters.snapshot()
        events, (_, records) = harness._profile(
            _recorded(lambda: solver.solve(pool[0], tol=tol,
                                           maxiter=harness.EAGER_STEPS)),
            tmp / "eager.json", device)
        delta = counters.diff(counters.snapshot(), before)
        joined = join(events, records)
        ops = owned(events, joined)
        per_call = {}
        for name, key in (("poms.k6r", "dw_reduce"),
                          ("poms.k6u", "dw_update")):
            rids = [r.id for r, _ in joined if r.name == name]
            kernels = sum(op.get("cat") == "kernel"
                          for rid in rids for op in ops.get(rid, ()))
            if kernels < delta.get(key, 0):
                raise IncompleteTrace(f"{name}: {kernels} kernels in the "
                                      f"trace, {delta[key]} launched")
            if rids:
                per_call[name] = sum(op["dur"] for rid in rids
                                     for op in ops[rid]) / len(rids)
        levels = level_device_us(joined, ops)
        out["eager"] = {
            "steps": harness.EAGER_STEPS,
            "coarse_share": coarse_share(joined, ops),
            "coarse_solve_us": (levels[COARSE][0] / levels[COARSE][1]
                                if COARSE in levels else None),
            "levels_us": {k: v[0] for k, v in levels.items()},
            "us_per_call": per_call}
        t_solve = time.perf_counter()
        solver.solve_compiled(pool[0], tol=tol, maxiter=maxiter,
                              return_x=False)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t_solve
        n = args.solves or max(2, min(harness.PROFILED_MAX,
                                      math.ceil(harness.PROFILED_S
                                                / t_solve)))
        before = counters.snapshot()
        events, ((window_s, its), records) = _replayed(
            solver, pool, tol, maxiter, n, tmp, device)
        delta = counters.diff(counters.snapshot(), before)
    counted = harness.hand_kernels(delta)
    if tr.kernel_count(events) < counted:
        raise IncompleteTrace(f"{tr.kernel_count(events)} kernels in the "
                              f"replayed trace, {counted} launched")
    joined = join(events, records)
    ops = owned(events, joined)
    window = next(e for e in events if e.get("name") == "bench.window")
    t0, t1 = window["ts"], window["ts"] + window["dur"]
    busy = tr.busy_us(events, t0, t1) * 1e-6
    gaps = replay_gaps(joined, ops)
    starts = start_intervals(joined, ops)
    per_replay = [sum(op.get("cat") == "kernel" for op in ops[r.id])
                  for r, _ in joined if r.name == REPLAY]
    out["replayed"] = {
        "solves": n, "iterations": its, "window_s": window_s,
        "busy_s": busy, "idle_share": 100.0 * (1.0 - busy / window_s),
        "replay_gap_us": sum(gaps) / len(gaps) if gaps else None,
        "replay_gaps": len(gaps),
        "start_ms": sum(starts) / len(starts) * 1e-3 if starts else None,
        "kernels_per_replay": [min(per_replay), max(per_replay)],
        "hand_kernels": counted,
        "copy_gb_per_iter": delta.get("graph.copy_bytes", 0) / its / 1e9,
        "idle_split": idle_split(events, joined, ops, t0, t1),
        "breakdown": tr.breakdown(events, t0, t1)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
