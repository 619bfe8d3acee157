"""One solver step captured as a CUDA graph and replayed per iteration.

An eager step of the double-word solvers is a few hundred small launches,
each costing the host more than the card; a captured graph replays them with
one call.  :class:`GraphedStep` holds the step's state in static buffers,
warms the step up on a side stream (kernel libraries loaded, launch plans
built, the library workspaces of the coarse solve allocated), captures one
step whose outputs are copied back into the state inside the graph, and
replays it.  Everything a step reads from the host at capture time (the
Chebyshev coefficients from the λ estimates, tile sizes) is baked into the
graph.  Capture failure raises: there is no eager path behind it.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from poms_tpu_torch.ops import counters

__all__ = ["GraphedStep"]


class GraphedStep:
    """``step(*state, *consts) -> (*new_state, rn)`` on CUDA tensors.

    ``state`` and ``consts`` are example tensors: static buffers of their
    shapes and dtypes are made here and filled by :meth:`load`.  ``rn`` is a
    0-dim tensor; after :meth:`replay` ``self.rn`` holds it.  Replays advance
    the wrappers' launch counters by the launches captured
    (``self.captured``)."""

    def __init__(self, step: Callable, state: Sequence[torch.Tensor],
                 consts: Sequence[torch.Tensor] = ()):
        dev = state[0].device
        if dev.type != "cuda":
            raise ValueError("a CUDA graph needs CUDA tensors")
        self.state = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                      for t in state]
        self.consts = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in consts]
        self.load(state, consts)
        with torch.cuda.device(dev):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                rn = step(*self.state, *self.consts)[-1]
                self.rn = torch.empty_like(rn)
            current.wait_stream(side)
            before = counters.snapshot()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                *new, rn = step(*self.state, *self.consts)
                for buf, t in zip(self.state, new):
                    buf.copy_(t)
                self.rn.copy_(rn)
            self.captured = counters.diff(counters.snapshot(), before)
        self.replays = 0

    def load(self, state, consts=()):
        for buf, t in zip(self.state, state):
            buf.copy_(t)
        for buf, t in zip(self.consts, consts):
            buf.copy_(t)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        counters.add(self.captured)
        self.replays += 1
        return self.rn
