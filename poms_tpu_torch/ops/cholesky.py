"""Coarsest-grid direct solve: a dense Cholesky factor of the coarse operator.

Counterpart of ``poms_tpu.ops.cholesky``: the tiny coarsest system is
factored once at setup and solved with two triangular solves per cycle.
Both are library calls (``torch.linalg``), as the JAX package's are.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["DenseCholesky", "factor_dense_cholesky"]


@dataclass
class DenseCholesky:
    """Lower-triangular Cholesky factor of the flattened coarse operator."""
    L: torch.Tensor

    def solve(self, b_flat: torch.Tensor) -> torch.Tensor:
        b = b_flat.reshape(-1, 1)
        y = torch.linalg.solve_triangular(self.L, b, upper=False)
        return torch.linalg.solve_triangular(self.L.T, y,
                                             upper=True).reshape(-1)


def factor_dense_cholesky(A, dtype=None) -> DenseCholesky:
    """Factor an operator's dense form (host assembly, device factor)."""
    dtype = dtype or A.space.dtype
    Ad = torch.as_tensor(A.toarray(), dtype=dtype, device=A.space.device)
    return DenseCholesky(L=torch.linalg.cholesky(Ad))
