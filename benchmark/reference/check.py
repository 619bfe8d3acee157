"""The f64 residual ‖b − A·x‖₂ of the program's solutions, by the reference
kind's operator and the reference's own right-hand sides."""
from __future__ import annotations

import torch

from benchmark.reference.rhs import one

__all__ = ["residuals"]


def residuals(kind, problem: dict, sources, seed: int, solutions,
              device) -> list:
    """``kind``: the reference kind's module; ``problem``: the
    configuration's ``problem`` entry; ``solutions``: (pool slot, x) pairs,
    x a tensor of the program's of b's shape.  Returns ‖b − A·x‖₂ of each,
    A the kind's operator and b made again from the seed; a solution of
    another shape than b is refused, not broadcast."""
    A = kind.operator(problem, device)
    out = []
    for slot, x in solutions:
        b = one(kind, problem, sources, seed, slot, device)
        if tuple(x.shape) != tuple(b.shape):
            raise ValueError(
                f"the solution of pool slot {slot} has the shape "
                f"{tuple(x.shape)}, its right-hand side {tuple(b.shape)}")
        r = b - A.apply(x.to(device=device, dtype=torch.float64))
        out.append(float(torch.linalg.vector_norm(r)))
        del b, r
    return out
