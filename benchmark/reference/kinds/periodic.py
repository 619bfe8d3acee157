"""Reference kind ``periodic``: the shifted Helmholtz problem u − Δu (σ = 1
by default) of uniform periodic B-splines on the unit box of the
configuration's ``dim`` axes (3 where it names none),
A = σ·(M on every axis) + Σ_a (K on axis a, M on the others), in 3D
σ·M⊗M⊗M + K⊗M⊗M + M⊗K⊗M + M⊗M⊗K; the 1D loads the moments of
sin(2πmx), and every source scaled to the ‖b‖₂ of the manufactured
u = Π_a sin(2πx_a)."""
from __future__ import annotations

import math

import torch

from benchmark.reference.operator import kron_sum
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
        """A·x for an (n,)·d f64 field, d = 1, 2 or 3, by dense 1D products
        (no TF32)."""
        return kron_sum(self.K, self.M, x, self.shift)


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
    """‖b‖₂ of the manufactured source (σ + 4dπ²)·Π_a sin(2πx_a), d the
    problem's axes."""
    d = problem.get("dim", 3)
    s = float(torch.linalg.vector_norm(torch.as_tensor(load(problem, 1))))
    return (problem["shift"] + 4 * d * math.pi ** 2) * s ** d
