"""Spans inside the port, on the profiler's clock.

:func:`span` marks where a layer's work happens: a solve, its eager start,
one graph replay, a level of the cycle, the coarse solve, a K6r or K6u call,
a step of set-up.  While no recording is active it returns one shared null
context: it creates nothing, reads no clock and enters no
``record_function``, so a solve pays one function call a span.

Inside :func:`recording` each span appends a :class:`Record` (its name, its
id, its parent's id, the id of the enclosing ``poms.solve``, the
``perf_counter_ns`` clock at start and end, and its attributes, tensors
reduced to their shapes) and enters ``torch.profiler.record_function`` under
the same name, so a profiler running at the same time holds the span on its
own clock beside the kernels it launched.  The range's name carries no
per-call id: the k-th range of a name on a thread is the k-th record of that
name.  ``recording()`` is the one way in; there is no environment switch.

    from torch.profiler import ProfilerActivity, profile
    from poms_tpu_torch.utils import trace

    with trace.recording() as records, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.solve_compiled(b)
    prof.export_chrome_trace("solve.json")   # poms.* ranges beside kernels

A span given ``sync=True`` synchronizes the card before it closes, while
recording and never while the current stream captures a graph: set-up spans
use it so that their time holds the device work they queued.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch

__all__ = ["Record", "span", "recording"]

_NULL = nullcontext()
_active: Optional["_Recording"] = None


@dataclass
class Record:
    """One closed (or, while it runs, open) span."""
    name: str
    id: int
    parent: Optional[int]
    solve: Optional[int]            # id of the enclosing poms.solve
    start_ns: int
    end_ns: Optional[int] = None
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Recording:
    def __init__(self):
        self.records: List[Record] = []
        self.open: List[Record] = []


def _describe(value):
    """An attribute as a record keeps it: a tensor by its shape (a record
    must not keep a field alive), sequences element by element."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape)
    if isinstance(value, (list, tuple)):
        return tuple(_describe(v) for v in value)
    return value


def _synchronize():
    if torch.cuda.is_available() \
            and not torch.cuda.is_current_stream_capturing():
        torch.cuda.synchronize()


class _Span:
    def __init__(self, rec: _Recording, name: str, sync: bool, attrs: dict):
        self.rec, self.name, self.sync, self.attrs = rec, name, sync, attrs

    def __enter__(self):
        rec = self.rec
        parent = rec.open[-1] if rec.open else None
        own = len(rec.records)
        solve = parent.solve if parent is not None else None
        if solve is None and self.name == "poms.solve":
            solve = own
        self.record = Record(
            self.name, own, None if parent is None else parent.id, solve,
            time.perf_counter_ns(),
            attrs={k: _describe(v) for k, v in self.attrs.items()})
        rec.records.append(self.record)
        rec.open.append(self.record)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self.record

    def __exit__(self, *exc):
        try:
            if self.sync:
                _synchronize()
        finally:
            self.range.__exit__(*exc)
            self.record.end_ns = time.perf_counter_ns()
            self.rec.open.pop()
        return False


def span(name: str, sync: bool = False, **attrs):
    """A context manager around one piece of the port's work named
    ``name`` (``poms.*``): the shared null context unless recording."""
    if _active is None:
        return _NULL
    return _Span(_active, name, sync, attrs)


@contextmanager
def recording() -> Iterator[List[Record]]:
    """Turn spans on; yields the list their records are appended to, in
    the order they open.  Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already active")
    _active = _Recording()
    try:
        yield _active.records
    finally:
        _active = None
