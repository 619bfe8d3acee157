"""Reference kind ``periodic``: the shifted Helmholtz problem u − Δu (σ = 1
by default) of uniform periodic B-splines on the unit cube,
A = σ·M⊗M⊗M + K⊗M⊗M + M⊗K⊗M + M⊗M⊗K, the 1D loads the moments of
sin(2πmx), and every source scaled to the ‖b‖₂ of the manufactured
u = sin(2πx)·sin(2πy)·sin(2πz)."""
from __future__ import annotations

import math

import torch

from benchmark.reference.operator import _axis
from benchmark.reference.periodic_bspline import load as _load
from benchmark.reference.periodic_bspline import stiffness_mass


class ShiftedKronSum:
    """The operator of one grid, degree and shift σ, on ``device``, in
    f64."""

    def __init__(self, n_el: int, degree: int, shift: float, device):
        K, M = stiffness_mass(n_el, degree)
        self.K = torch.as_tensor(K, dtype=torch.float64, device=device)
        self.M = torch.as_tensor(M, dtype=torch.float64, device=device)
        self.shift = float(shift)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x for an (n, n, n) f64 field, by dense 1D products (no TF32)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        K, M = self.K, self.M
        mx = _axis(M, x, 2)
        kx = _axis(K, x, 2)
        # axis 1, then axis 0: K⊗(M⊗M) x + M⊗(K⊗M + M⊗K + σ·M⊗M) x
        mm = _axis(M, mx, 1)
        inner = _axis(K, mx, 1)
        del mx
        inner += _axis(M, kx, 1)
        del kx
        inner += self.shift * mm
        out = _axis(K, mm, 0)
        del mm
        out += _axis(M, inner, 0)
        return out


def operator(problem: dict, device) -> ShiftedKronSum:
    """A, whose ``apply(x)`` is A·x in f64."""
    return ShiftedKronSum(problem["n_el"], problem["degree"],
                          problem["shift"], device)


def load(problem: dict, mode: int):
    """The 1D load vector ∫ sin(2π·mode·x) B_i(x) dx."""
    return _load(problem["n_el"], problem["degree"], mode)


def mirror_sign(mode: int) -> float:
    """−1: sin(2πm(1 − x)) = −sin(2πmx)."""
    return -1.0


def target_norm(problem: dict) -> float:
    """‖b‖₂ of the manufactured source (σ + 12π²)·sin(2πx)·sin(2πy)·
    sin(2πz)."""
    s = float(torch.linalg.vector_norm(torch.as_tensor(load(problem, 1))))
    return (problem["shift"] + 12 * math.pi ** 2) * s ** 3
