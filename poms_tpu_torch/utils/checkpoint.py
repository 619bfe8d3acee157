"""Checkpoint/resume of solver state between cycles.

Counterpart of ``poms_tpu.utils.checkpoint`` with the same file: a
compressed ``npz`` holding the solution iterate, the residual history, the
cycle index and the problem metadata as a JSON string.  A torch tensor
(on any device) is saved through its host numpy copy; loading returns numpy
arrays, which ``StencilVector.from_interior`` takes as they are.
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np

__all__ = ["save_solver_state", "load_solver_state"]


def save_solver_state(path: str, x_interior, residuals, iteration: int,
                      meta: dict | None = None) -> None:
    if hasattr(x_interior, "detach"):
        x_interior = x_interior.detach().cpu().numpy()
    np.savez_compressed(
        path,
        x=np.asarray(x_interior),
        residuals=np.asarray(residuals, np.float64),
        iteration=np.int64(iteration),
        meta=np.array(json.dumps(meta or {})),
    )


def load_solver_state(path: str) -> Tuple[np.ndarray, list, int, dict]:
    with np.load(path, allow_pickle=False) as z:
        x = z["x"]
        residuals = list(z["residuals"])
        iteration = int(z["iteration"])
        meta = json.loads(str(z["meta"]))
    return x, residuals, iteration, meta
