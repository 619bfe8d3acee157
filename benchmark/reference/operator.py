"""The 3D Poisson stiffness operator A = K⊗M⊗M + M⊗K⊗M + M⊗M⊗K, applied
in f64 with plain dense 1D products along each axis (no TF32: f64 matmuls
do not take it, and it is switched off besides)."""
from __future__ import annotations

import torch

from benchmark.reference.bspline import stiffness_mass

__all__ = ["KronSum"]


def _axis(B: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """B applied along ``axis`` of the 3D field ``x``."""
    n0, n1, n2 = x.shape
    if axis == 0:
        return (B @ x.reshape(n0, n1 * n2)).reshape(n0, n1, n2)
    if axis == 1:
        return torch.matmul(B, x)
    return (x.reshape(n0 * n1, n2) @ B.T).reshape(n0, n1, n2)


class KronSum:
    """The operator of one grid and degree, on ``device``, in f64."""

    def __init__(self, n_el: int, degree: int, device):
        K, M = stiffness_mass(n_el, degree)
        self.K = torch.as_tensor(K, dtype=torch.float64, device=device)
        self.M = torch.as_tensor(M, dtype=torch.float64, device=device)
        self.n = K.shape[0]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x for an (n, n, n) f64 field."""
        torch.backends.cuda.matmul.allow_tf32 = False
        K, M = self.K, self.M
        mx = _axis(M, x, 2)
        kx = _axis(K, x, 2)
        # axis 1, then axis 0: K⊗M⊗M x + M⊗(K⊗M + M⊗K) x
        mm = _axis(M, mx, 1)
        inner = _axis(K, mx, 1)
        del mx
        inner += _axis(M, kx, 1)
        del kx
        out = _axis(K, mm, 0)
        del mm
        out += _axis(M, inner, 0)
        return out
