"""Structured convergence logging.

Counterpart of ``poms_tpu.utils.logging`` with the same records: JSON lines
of ``{event: "cycle", cycle, residual, rho, wall_s, elapsed_s}`` after an
optional ``start`` record carrying ``meta``, written to a file or any
stream, closed by an optional ``done`` record.  The solvers' ``solve``
methods take such a logger and call :meth:`ConvergenceLogger.log_cycle`
once per cycle or iteration.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

__all__ = ["ConvergenceLogger"]


class ConvergenceLogger:
    def __init__(self, stream: Optional[IO] = None, path: Optional[str] = None,
                 meta: Optional[dict] = None):
        if path is not None:
            self._fh = open(path, "w")
            self._own = True
        else:
            self._fh = stream or sys.stdout
            self._own = False
        self._t0 = time.perf_counter()
        if meta:
            self._emit({"event": "start", **meta})

    def _emit(self, rec: dict):
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_cycle(self, cycle: int, residual: float, rho: float,
                  wall_s: float, **extra):
        self._emit({"event": "cycle", "cycle": cycle, "residual": residual,
                    "rho": rho, "wall_s": wall_s,
                    "elapsed_s": time.perf_counter() - self._t0, **extra})

    def close(self, **summary):
        if summary:
            self._emit({"event": "done", **summary})
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
