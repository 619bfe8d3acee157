"""Coarsest-grid direct solve: a dense Cholesky factor of the coarse operator.

Counterpart of ``poms_tpu.ops.cholesky``: the tiny coarsest system is
factored once at setup and solved with two triangular solves per cycle.
Both are library calls (``torch.linalg``), as the JAX package's are.

A bf16 level keeps an f32 factor: ``torch.linalg.solve_triangular`` has no
bf16 path on the CPU and none worth having on the card, so
:meth:`DenseCholesky.solve` casts a right-hand side of another dtype up to the
factor's, solves there and casts the result back.  The JAX package solves in
bf16 on a factor cast to bf16 (``poms_tpu/ops/cholesky.py:27-29``); the
port's coarse solve is at least as exact and not bitwise with it.
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
        """L Lᵀ x = b, in the factor's dtype; x has ``b_flat``'s dtype."""
        b = b_flat.reshape(-1, 1).to(self.L.dtype)
        y = torch.linalg.solve_triangular(self.L, b, upper=False)
        x = torch.linalg.solve_triangular(self.L.T, y, upper=True)
        return x.reshape(-1).to(b_flat.dtype)


def factor_dense_cholesky(A, dtype=None) -> DenseCholesky:
    """Factor an operator's dense form (host assembly, device factor)."""
    dtype = dtype or A.space.dtype
    Ad = torch.as_tensor(A.toarray(), dtype=dtype, device=A.space.device)
    return DenseCholesky(L=torch.linalg.cholesky(Ad))
