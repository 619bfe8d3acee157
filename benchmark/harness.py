"""One run of one cell: set-up, the measured window, the traced phases and
the check of the window's solutions against the plain reference.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file that names, its traffic in
``benchmark/traffic/<traffic>.json``, each metric's reader in
``benchmark/metrics/<metric>.py``, and the kinds its configuration names
(:func:`kinds`): the program's problem in ``benchmark/problems/<kind>.py``,
its solver in ``benchmark/solvers/<kind>.py`` and the plain reference's
side of the problem in ``benchmark/reference/kinds/<kind>.py``.  A later
cell, configuration, traffic mix, metric, problem, solver or reference is a
new file and a new entry; no file here names one.
"""
from __future__ import annotations

import copy
import gc
import importlib.util
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from benchmark import trace as tr
from benchmark import work
from benchmark.reference import check as ref_check
from benchmark.reference import rhs

__all__ = ["ROOT", "manifest", "cell", "metric_names", "reader", "kinds",
           "Context", "build", "run", "FORBIDDEN"]

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "poms_tpu")
# counters of ops/counters.py that count one launched kernel each (the
# others repeat these: ``kron_apply`` is ``kron_mode.apply``, the ``_rt``
# keys split K1r's and K5r's launches by pass, ``@dtype`` by dtype)
HAND_KERNELS = ("kron_mode", "residual_kron_df", "dw_reduce", "dw_update",
                "transfer", "stencil_apply", "stencil_apply_v2")
DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
# where each kind a configuration names is found: the problem's kind (its
# ``problem.kind``, "poisson" where it names none) selects the program's
# problem and the reference's side of it, ``solver.kind`` the solver
KIND_DIRS = {"problem": "benchmark/problems", "solver": "benchmark/solvers",
             "reference": "benchmark/reference/kinds"}
EAGER_STEPS = 3            # eager steps the rooflines are read over
PROFILED_S = 0.5           # whole solves replayed under the profiler: about
PROFILED_MAX = 10          # this long, at least 2 and at most this many


# -- finding things by name ---------------------------------------------------

def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, name: str, root: Path = ROOT):
    """(workload entry, configuration, traffic) of the cell ``name``."""
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    wl = found[0]
    entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    return wl, config, traffic


def metric_names(man: dict, name: str, traced: bool) -> list:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones:
    every metric that lists the cell, or lists no cells."""
    group = man["per_layer" if traced else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The module ``benchmark/metrics/<name>.py``."""
    return _module(root / "benchmark" / "metrics" / f"{name}.py",
                   "benchmark_metric_" + name)


def kinds(config: dict, root: Path = ROOT) -> dict:
    """{"problem", "solver", "reference": module} of the kinds ``config``
    names, each loaded from its file under :data:`KIND_DIRS`.  A kind with
    no file is refused, naming the path looked for, before any is loaded."""
    problem = config["problem"].get("kind", "poisson")
    named = {"problem": problem, "solver": config["solver"]["kind"],
             "reference": problem}
    paths = {role: root / KIND_DIRS[role] / f"{kind}.py"
             for role, kind in named.items()}
    for role, path in paths.items():
        if not path.is_file():
            raise FileNotFoundError(
                f"configuration {config.get('name')!r} names the {role} "
                f"kind {named[role]!r}, and there is no {path}")
    return {role: _module(path, f"benchmark_{role}_{named[role]}")
            for role, path in paths.items()}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


# -- the program --------------------------------------------------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, kind: dict, traffic: dict, seed: int, device,
          times: dict):
    """(problem, solver, pool) of the configuration, by the modules of its
    kinds (``kind``, as :func:`kinds` gives them), timing each into
    ``times``: the pool holds the traffic's right-hand sides for ``seed``,
    made by the reference kind and handed to the program as its vectors."""
    pr = config["problem"]
    t0 = time.perf_counter()
    prob = kind["problem"].make(pr, DTYPES[pr["dtype"]], device)
    _sync(device)
    times["problem"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = kind["solver"].make(prob, config["solver"], pr, DTYPES)
    _sync(device)
    times["solver"] = time.perf_counter() - t0
    prob.b = None              # the cell brings its own right-hand sides
    from poms_tpu_torch.core.vector import StencilVector

    t0 = time.perf_counter()
    pool = [StencilVector.from_interior(prob.space, b.to(prob.space.dtype))
            for b in rhs.pool(kind["reference"], pr, traffic["sources"], seed,
                              device)]
    _sync(device)
    times["rhs"] = time.perf_counter() - t0
    return prob, solver, pool


def _counters():
    from poms_tpu_torch.ops import counters
    return counters


def hand_kernels(delta: dict, names=HAND_KERNELS) -> int:
    """Kernels launched by the hand-written kernels' wrappers in a
    ``counters.diff``: each wrapper's total over its modes, once."""
    return sum(n for k, n in delta.items()
               if "@" not in k and k.split(".")[0] in names)


# -- spans around the layers' entries (the traced run) ------------------------

class Spans:
    """``record_function`` ranges around the entries that the cell's
    roofline metrics name (``SPANS`` in their readers), one range a call,
    with the call's work."""

    def __init__(self, spans: dict):
        self.spans = spans          # layer -> SPAN dict
        self.calls = {}             # range name -> (layer, bytes, flops, dt)

    @contextmanager
    def installed(self):
        from torch.profiler import record_function

        saved = []
        for layer, span in self.spans.items():
            mod = importlib.import_module(span["module"])
            orig = getattr(mod, span["entry"])

            def wrapped(*a, _orig=orig, _layer=layer, _work=span["work"],
                        **k):
                name = f"bench.{_layer}#{len(self.calls)}"
                self.calls[name] = (_layer, *_work(a, k))
                with record_function(name):
                    return _orig(*a, **k)
            saved.append((mod, span["entry"], orig))
            setattr(mod, span["entry"], wrapped)
        try:
            yield self
        finally:
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)


def _profile(fn, path: Path, device):
    """Run ``fn`` under the profiler (the host, and the card where the run
    is on one); the trace's events and what ``fn`` returned."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        out = fn()
        _sync(device)
    prof.export_chrome_trace(str(path))
    events = tr.load(path)
    path.unlink()
    return events, out


class IncompleteProfile(RuntimeError):
    """The profile holds fewer kernels than the program launched."""


# -- what the readers read ----------------------------------------------------

class Context:
    """The numbers of one run that the metric readers take theirs from."""

    def __init__(self):
        self.solves = []            # (seconds, iterations, converged)
        self.window_s = 0.0
        self.setup = {}             # total, problem, solver, capture
        self.peak_bytes = 0
        self.window_counters = {}
        self.layers = {}            # layer -> (least s, device s)
        self.replay = None          # {"busy_s", "window_s", "breakdown"}

    @property
    def iterations(self) -> int:
        return sum(s[1] for s in self.solves)

    def roofline(self, layer: str):
        """Percent of the least time over the device time, over every call
        into ``layer`` in the eager steps; None where it made none."""
        least, dev = self.layers.get(layer, (0.0, 0.0))
        if dev <= 0:
            return None
        return 100.0 * least / dev


# -- one run ------------------------------------------------------------------

def _window(solver, pool, tol, maxiter, seconds, keep, seed, device, ctx):
    """Closed-loop solves through the pool until ``seconds`` have passed;
    keeps a sample of ``keep`` solutions drawn from the seed (reservoir)."""
    rng = random.Random(seed ^ 0xC4EC)
    kept = []
    t_start = time.perf_counter()
    i = 0
    while True:
        slot = i % len(pool)
        t0 = time.perf_counter()
        x, rn, it = solver.solve_compiled(pool[slot], tol=tol,
                                          maxiter=maxiter, return_x=False)
        _sync(device)
        t1 = time.perf_counter()
        rn = float(rn)
        ctx.solves.append((t1 - t0, int(it), math.isfinite(rn) and rn <= tol))
        if len(kept) < keep:
            kept.append((slot, x))
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                kept[j] = (slot, x)
        del x
        i += 1
        if t1 - t_start >= seconds:
            break
    ctx.window_s = t1 - t_start
    return kept


def _rooflines(solver, b, tol, spans: dict, ctx, tmp: Path, device):
    """Eager steps of the solver with a range around every call into the
    spanned layers: each layer's least time and device time."""
    counters = _counters()
    ranges = Spans(spans)
    before = counters.snapshot()
    with ranges.installed():
        events, _ = _profile(
            lambda: solver.solve(b, tol=tol, maxiter=EAGER_STEPS),
            tmp / "rooflines.json", device)
    delta = counters.diff(counters.snapshot(), before)
    per_range = tr.by_range(events)
    for layer, span in spans.items():
        names = [n for n, c in ranges.calls.items() if c[0] == layer]
        counted = hand_kernels(delta, span["counters"])
        seen = sum(per_range.get(n, (0, 0))[1] for n in names)
        if seen < counted:
            raise IncompleteProfile(
                f"the profile of {EAGER_STEPS} eager steps holds {seen} "
                f"kernels launched in the '{layer}' ranges, the program "
                f"counted {counted}: it lost device events")
        least = sum(work.least_s(*ranges.calls[n][1:]) for n in names)
        dev = sum(per_range.get(n, (0.0, 0))[0] for n in names) * 1e-6
        ctx.layers[layer] = (least, dev)


def _replayed(solver, pool, tol, maxiter, solve_s, ctx, tmp: Path, device):
    """Whole solves under the profiler: the device's busy time against a
    CUDA-event window, and the breakdown."""
    from torch.profiler import record_function

    counters = _counters()
    n = max(2, min(PROFILED_MAX, math.ceil(PROFILED_S / solve_s)))

    def solves():
        with record_function("bench.window"):
            if device.type != "cuda":       # the CPU rehearsal
                t0 = time.perf_counter()
                for i in range(n):
                    solver.solve_compiled(pool[i % len(pool)], tol=tol,
                                          maxiter=maxiter, return_x=False)
                return time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                solver.solve_compiled(pool[i % len(pool)], tol=tol,
                                      maxiter=maxiter, return_x=False)
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3

    before = counters.snapshot()
    events, window_s = _profile(solves, tmp / "replayed.json", device)
    counted = hand_kernels(counters.diff(counters.snapshot(), before))
    seen = tr.kernel_count(events)
    if seen < counted:
        raise IncompleteProfile(
            f"the profile of {n} replayed solves holds {seen} kernels, the "
            f"program counted {counted}: it lost device events")
    host = [e for e in events if e.get("name") == "bench.window"]
    t0, t1 = host[0]["ts"], host[0]["ts"] + host[0]["dur"]
    busy = tr.busy_us(events, t0, t1) * 1e-6
    ctx.replay = {"busy_s": busy, "window_s": window_s,
                  "breakdown": tr.breakdown(events, t0, t1)}


def run(man: dict, name: str, seed: int, seconds: float, traced: bool,
        device, t_process: float, solve_hook=None, root: Path = ROOT,
        control: bool = False) -> dict:
    """One run of the cell ``name``; returns the result line's object.
    ``solve_hook(solver)`` (tests) may replace the solver's timed path;
    ``control`` runs the configuration's control (its ``control`` entry
    merged over it: the program one precision lower) in its place."""
    wl, config, traffic = cell(man, name, root)
    if control:
        config = _merge(config, config["control"])
    os.environ.pop("POMS_TPU_SPMV", None)     # the default engine, K2
    ctx = Context()
    times = {"before": time.perf_counter() - t_process}
    t0 = time.perf_counter()
    kind = kinds(config, root)          # refused here, before any set-up
    times["kinds"] = time.perf_counter() - t0
    prob, solver, pool = build(config, kind, traffic, seed, device, times)
    if solve_hook is not None:
        solve_hook(solver)
    tol, maxiter = config["tol"], config["maxiter"]
    t0 = time.perf_counter()
    x, rn, it = solver.solve_compiled(pool[0], tol=tol, maxiter=maxiter,
                                      return_x=False)
    _sync(device)
    times["capture"] = time.perf_counter() - t0
    del x
    counters = _counters()
    before = counters.snapshot()
    ctx.setup = {"total": time.perf_counter() - t_process, **times}
    kept = _window(solver, pool, tol, maxiter, seconds,
                   config["check"]["solutions"], seed, device, ctx)
    ctx.window_counters = counters.diff(counters.snapshot(), before)
    if device.type == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated(device)
    readers = {m["name"]: reader(m["name"], root)
               for m in metric_names(man, name, traced)}
    if traced:
        spans = {}
        for mod in readers.values():
            spans.update(getattr(mod, "SPANS", {}))
        with tempfile.TemporaryDirectory() as tmp:
            if spans:
                _rooflines(solver, pool[0], tol, spans, ctx, Path(tmp),
                           device)
            _replayed(solver, pool, tol, maxiter,
                      ctx.window_s / len(ctx.solves), ctx, Path(tmp), device)
    # the program's state goes before the reference runs
    del solver, prob, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    residuals = ref_check.residuals(
        kind["reference"], config["problem"], traffic["sources"], seed, kept,
        device)
    del kept
    failed = sum(not s[2] for s in ctx.solves)
    limit = config["check"]["residual_limit"]
    worst = max(residuals) if residuals else math.inf
    checks = {"true_residual_max": {"value": worst, "limit": limit},
              "failed_solves": {"value": failed, "limit": 0}}
    correct = (bool(residuals) and all(math.isfinite(r) for r in residuals)
               and worst <= limit and failed == 0)
    metrics = {}
    for m in metric_names(man, name, traced):
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(ctx.solves),
           "failed": failed, "metrics": metrics,
           "device": _device(device, wl["chips"], ctx)}
    if traced:
        out["breakdown"] = ctx.replay["breakdown"]
    out["iterations_by_slot"] = _iterations(ctx, len(traffic["sources"]))
    out["setup_parts"] = ctx.setup
    out["checks"] = checks
    return out


def _iterations(ctx, slots: int) -> list:
    """Each pool slot's iteration counts over the window (the same source
    takes the same count on every seed, up to rounding)."""
    return [sorted({ctx.solves[i][1]
                    for i in range(k, len(ctx.solves), slots)})
            for k in range(slots)]


def _device(device, chips: int, ctx) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": ctx.peak_bytes}
    if ctx.replay is not None:
        out["busy_s"] = ctx.replay["busy_s"]
        out["window_s"] = ctx.replay["window_s"]
    return out


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of ``values``, inclusive method."""
    if len(values) == 1:
        return values[0]
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return cuts[round(q * 100) - 1]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
