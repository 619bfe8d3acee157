"""The f64 residual ‖b − A·x‖₂ of the program's solutions, by the reference
operator and the reference's own right-hand sides."""
from __future__ import annotations

import torch

from benchmark.reference.operator import KronSum
from benchmark.reference.rhs import one

__all__ = ["residuals"]


def residuals(n_el: int, degree: int, sources, seed: int, solutions,
              device) -> list:
    """``solutions``: (pool slot, x) pairs, x an (n, n, n) tensor of the
    program's.  Returns ‖b − A·x‖₂ of each, b made again from the seed."""
    A = KronSum(n_el, degree, device)
    out = []
    for slot, x in solutions:
        b = one(n_el, degree, sources, seed, slot, device)
        r = b - A.apply(x.to(device=device, dtype=torch.float64))
        out.append(float(torch.linalg.vector_norm(r)))
        del b, r
    return out
