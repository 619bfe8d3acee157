"""Reference kind ``poisson``: Poisson on the unit box of the configuration's
``dim`` axes (3 where it names none) with homogeneous Dirichlet conditions,
A = Σ_a (K on axis a, M on the others), in 3D K⊗M⊗M + M⊗K⊗M + M⊗M⊗K; the
1D loads the moments of sin(mπx), and every source scaled to the
manufactured source's ‖b‖₂."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.bspline import load as _load
from benchmark.reference.operator import KronSum


def operator(problem: dict, device) -> KronSum:
    """A, whose ``apply(x)`` is A·x in f64."""
    return KronSum(problem["n_el"], problem["degree"], device)


def load(problem: dict, mode: int) -> np.ndarray:
    """The 1D interior load vector ∫ sin(mode·π·x) B_i(x) dx."""
    return _load(problem["n_el"], problem["degree"], mode)


def mirror_sign(mode: int) -> float:
    """(−1)^(mode+1): sin(mπ(1 − x)) = (−1)^(m+1)·sin(mπx)."""
    return -1.0 if mode % 2 == 0 else 1.0


def target_norm(problem: dict) -> float:
    """‖b‖₂ of the manufactured source dπ²·Π_a sin(πx_a), d the problem's
    axes (in 3D 3π²·sin(πx)·sin(πy)·sin(πz))."""
    d = problem.get("dim", 3)
    s = float(torch.linalg.vector_norm(torch.as_tensor(load(problem, 1))))
    return d * math.pi ** 2 * s ** d
