"""Communication/compute overlap from profiler traces of a distributed step.

Counterpart of ``poms_tpu/bench/overlap_trace.py`` on ``torch.profiler``.
The overlap form of the banded SpMV (``parallel/halo.py::dist_spmv``,
``overlap=True``) posts the halo messages and computes the interior before
it waits on them; whether the two really run at once shows only in a
trace.  Every rank of a distributed run

1. captures a ``torch.profiler`` trace around one ``DistributedMG.step``
   (after a warm step) and exports it as Chrome JSON,
2. parses it into complete ('X') events (name, category, start, duration),
3. classifies them: COMM — NCCL kernels, gloo's send, receive and
   collectives on the host (``gloo:*``), and the copies between the card
   and host memory (``Memcpy DtoH`` / ``HtoD``: the staged halo slabs under
   gloo, and the scalar reads); COMPUTE — every other device kernel (K2/K3,
   K7, K6, the plain contractions' kernels) or, in a trace without device
   kernels (CPU ranks), the host's arithmetic ops (``aten::mul``,
   ``aten::add``, ...),
4. reports the share of COMM wall time that lies under an open COMPUTE
   interval (the overlap fraction), and of the step's wall time (the
   ``overlap_step`` span) the device's busy share and the copies' share.

    python -m poms_tpu_torch.bench.overlap_trace [out.json] [--ab]
        (--backend gloo|nccl | --cpu) [--ranks N] [--dim D] [--n-el N]

On one card the ranks share it: the numbers show the wiring and the
host's share of a cycle, not the scaling of several cards.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Dict, List, Tuple

__all__ = ["capture_trace", "parse_perfetto", "overlap_report",
           "run_overlap_check", "run_overlap_ab", "rank_overlap"]

_SPAN = "overlap_step"
_COMM_KEYS = ("nccl", "gloo:", "memcpy dtoh", "memcpy htod")
# the host's arithmetic: what a CPU rank's contractions and sweeps run
_HOST_COMPUTE = ("aten::mul", "aten::add", "aten::sub", "aten::div",
                 "aten::addcmul", "aten::mm", "aten::bmm", "aten::matmul",
                 "aten::tensordot", "aten::linalg", "aten::where",
                 "aten::dot", "aten::vdot", "aten::sum")
_SKIP_KEYS = ("thread", "process", "Steps", "Profiler", "Flow")


def capture_trace(fn, args, log_dir: str) -> str:
    """Run ``fn(*args)`` under ``torch.profiler`` (the CPU, and the card
    when there is one) inside an ``overlap_step`` span; return the path of
    the exported Chrome JSON trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(_SPAN):
            fn(*args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def parse_perfetto(path: str) -> List[Dict]:
    """Flatten a Chrome JSON trace to its complete ('X') events."""
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if any(k in name for k in _SKIP_KEYS):
            continue
        out.append({"name": name, "cat": e.get("cat", ""),
                    "ts": float(e.get("ts", 0.0)),
                    "dur": float(e.get("dur", 0.0)),
                    "tid": e.get("tid"), "pid": e.get("pid")})
    return out


def _merge(intervals: List[Tuple[float, float]]):
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for s, t in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _intersect_len(a, b) -> float:
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _is_device(e) -> bool:
    return e.get("cat", "") in ("kernel", "gpu_memcpy", "gpu_memset")


def overlap_report(events: List[Dict]) -> Dict:
    """Overlap fraction = |comm ∩ compute| / |comm| over merged wall
    intervals; with the ``overlap_step`` span, also the step's wall time,
    the device's busy and idle shares and the card↔host copies' share."""
    device_kernels = any(e.get("cat") == "kernel" for e in events)
    comm, compute, busy, copies, span = [], [], [], [], None
    for e in events:
        if e["dur"] <= 0:
            continue
        lo = e["name"].lower()
        iv = (e["ts"], e["ts"] + e["dur"])
        if e["name"] == _SPAN:
            span = iv
            continue
        if _is_device(e):
            busy.append(iv)
            if "memcpy" in lo:
                copies.append(iv)
        if any(k in lo for k in _COMM_KEYS):
            comm.append(iv)
        elif (e.get("cat") == "kernel" if device_kernels
              else any(lo.startswith(k) for k in _HOST_COMPUTE)):
            compute.append(iv)
    comm_m, comp_m = _merge(comm), _merge(compute)
    comm_total = sum(t - s for s, t in comm_m)
    inter = _intersect_len(comm_m, comp_m)
    rep = {
        "n_comm_events": len(comm),
        "n_compute_events": len(compute),
        "comm_wall_us": comm_total,
        "overlapped_us": inter,
        "overlap_fraction": (inter / comm_total) if comm_total > 0 else None,
    }
    if span is not None:
        wall = span[1] - span[0]
        busy_us = sum(t - s for s, t in _merge(busy))
        copy_us = sum(t - s for s, t in _merge(copies))
        rep.update(step_wall_us=wall, device_busy_us=busy_us,
                   device_idle_share=(1.0 - busy_us / wall
                                      if device_kernels and wall > 0
                                      else None),
                   copy_us=copy_us,
                   copy_share=copy_us / wall if wall > 0 else None)
    return rep


def rank_overlap(spec: dict) -> Dict:
    """What every rank runs: build the spec's ``DistributedMG`` (the JAX
    check's problem by default: 2D, p = 2, two levels; Jacobi ω = 0.8,
    ν1 = ν2 = 1; the JAX check's rank grid), then for each arm of
    ``arms`` (``overlap`` on or off: the flag is read at every apply) warm
    one step and capture the next."""
    import torch

    from poms_tpu_torch.examples import rank_device
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    dev = rank_device(spec["device"])
    ranks = torch.distributed.get_world_size()
    dim = spec.get("dim", 2)
    mesh = (2, ranks // 2) if ranks >= 4 else (min(2, ranks), 1)
    mesh = mesh + (1,) * (dim - len(mesh))
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    prob = poisson_problem(dim, spec.get("n_el", 32),
                           degree=spec.get("degree", 2), dtype=dtype,
                           device=dev)
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        kind="jacobi", omega=0.8))
    mg = DistributedMG(prob, num_levels=spec.get("levels", 2),
                       mesh_shape=mesh, cfg=cfg, overlap=True)
    b = mg.local(prob.b.interior)
    del prob
    x0 = torch.zeros_like(b)
    out = {}
    for arm in spec.get("arms", (True,)):
        mg.overlap = arm
        x, _ = mg.step(x0, b)         # warm: faces, plans, buffers
        torch.distributed.barrier()   # the ranks enter the capture together
        with tempfile.TemporaryDirectory() as td:
            path = capture_trace(lambda: mg.step(x, b), (), td)
            rep = overlap_report(parse_perfetto(path))
        rep.update(platform=dev.type, n_ranks=ranks, mesh_shape=list(mesh),
                   overlap_formulation=arm,
                   backend=torch.distributed.get_backend())
        out["overlap_true" if arm else "overlap_false"] = rep
    return out


def _spawn(spec, backend, ranks):
    from poms_tpu_torch.parallel.launch import spawn

    return spawn(rank_overlap, ranks, backend, args=(spec,))


def run_overlap_check(out_json: str | None = None, n_el: int = 32,
                      overlap: bool = True, *, backend: str,
                      ranks: int = 2, device=None, **spec) -> Dict:
    """Capture and analyse one distributed step on ``ranks`` ranks; rank
    0's report (``per_rank``: every rank's)."""
    reps = _spawn({"n_el": n_el, "device": device, "arms": (overlap,),
                   **spec}, backend, ranks)
    key = "overlap_true" if overlap else "overlap_false"
    rep = dict(reps[0][key])
    rep["per_rank"] = [r[key] for r in reps]
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


def run_overlap_ab(out_json: str | None = None, n_el: int = 32,
                   *, backend: str, ranks: int = 2, device=None,
                   **spec) -> Dict:
    """The same step captured with ``overlap=True`` and ``False`` (one
    solver, the flag flipped between the captures); both fractions and
    their difference, from rank 0, with every rank's reports."""
    reps = _spawn({"n_el": n_el, "device": device, "arms": (True, False),
                   **spec}, backend, ranks)
    rep = {arm: reps[0][arm] for arm in ("overlap_true", "overlap_false")}
    ft = rep["overlap_true"]["overlap_fraction"]
    ff = rep["overlap_false"]["overlap_fraction"]
    rep["fraction_gain"] = (ft - ff) if (ft is not None and ff is not None) \
        else None
    rep["per_rank"] = reps
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    from poms_tpu_torch.examples import dist_cli, flag, int_args

    argv = sys.argv[1:]
    backend, ranks, device = dist_cli(argv)
    pos = int_args(argv)
    out = pos[0] if pos else None
    kw = dict(backend=backend, ranks=ranks, device=device,
              dim=flag(argv, "--dim", int, 2),
              n_el=flag(argv, "--n-el", int, 32))
    rep = (run_overlap_ab(out, **kw) if "--ab" in argv
           else run_overlap_check(out, **kw))
    rep.pop("per_rank", None)
    print(json.dumps(rep, indent=1))
