"""The Poisson stiffness operator A = Σ_a (K on axis a, M on the others) of
a field of 1, 2 or 3 axes (in 3D K⊗M⊗M + M⊗K⊗M + M⊗M⊗K), applied in f64
with plain dense 1D products along each axis (no TF32: f64 matmuls do not
take it, and it is switched off besides)."""
from __future__ import annotations

import math

import torch

from benchmark.reference.bspline import stiffness_mass

__all__ = ["KronSum", "kron_sum"]


def _axis(B: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """B applied along ``axis`` of the field ``x``."""
    shape = x.shape
    n = shape[axis]
    if axis == x.ndim - 1:
        return (x.reshape(-1, n) @ B.T).reshape(shape)
    pre, post = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    if pre == 1:
        return (B @ x.reshape(n, post)).reshape(shape)
    return torch.matmul(B, x.reshape(pre, n, post)).reshape(shape)


def kron_sum(K: torch.Tensor, M: torch.Tensor, x: torch.Tensor,
             shift=None) -> torch.Tensor:
    """Σ_a (K on axis a, M on the others)·x, plus ``shift``·(M on every
    axis)·x where a shift is given, for a field of 1, 2 or 3 axes: the
    axes contracted from the last to the first, the M-only partial and the
    partial of one K carried along (in 3D: K⊗(M⊗M) x + M⊗(K⊗M + M⊗K) x)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    last = x.ndim - 1
    if last == 0:
        mm, inner = x, None
    else:
        mm, inner = _axis(M, x, last), _axis(K, x, last)
        for a in range(last - 1, 0, -1):
            nxt = _axis(K, mm, a)
            nxt += _axis(M, inner, a)
            mm, inner = _axis(M, mm, a), nxt
    if shift is not None:
        if inner is None:
            inner = shift * mm
        else:
            inner += shift * mm
    out = _axis(K, mm, 0)
    del mm
    if inner is not None:
        out += _axis(M, inner, 0)
    return out


class KronSum:
    """The operator of one grid and degree, on ``device``, in f64."""

    def __init__(self, n_el: int, degree: int, device):
        K, M = stiffness_mass(n_el, degree)
        self.K = torch.as_tensor(K, dtype=torch.float64, device=device)
        self.M = torch.as_tensor(M, dtype=torch.float64, device=device)
        self.n = K.shape[0]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x for an (n,)·d f64 field, d = 1, 2 or 3."""
        return kron_sum(self.K, self.M, x)
