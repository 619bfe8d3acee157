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
    x an (n, n, n) tensor of the program's.  Returns ‖b − A·x‖₂ of each, A
    the kind's operator and b made again from the seed."""
    A = kind.operator(problem, device)
    out = []
    for slot, x in solutions:
        b = one(kind, problem, sources, seed, slot, device)
        r = b - A.apply(x.to(device=device, dtype=torch.float64))
        out.append(float(torch.linalg.vector_norm(r)))
        del b, r
    return out
