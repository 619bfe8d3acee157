"""Tensor-product B-spline Poisson problems (1D/2D/3D).

Counterpart of ``poms_tpu.models.poisson``: −Δu = f on the unit d-cube,
homogeneous Dirichlet conditions, degree-p B-splines.  The stiffness
operator is A = Σ_a M ⊗ … ⊗ K_a ⊗ … ⊗ M, held either as a banded
:class:`StencilMatrix` (``operator="banded"``, the default: the band of
(2p+1)^d coefficients per point, composed on the device from the 1D bands)
or as a :class:`KroneckerSumOperator` (``operator="kron"``: the 1D bands
only).  The manufactured solution u = Π_a sin(π x_a) gives f = d π² u, so
the RHS is an outer product of 1D sine moments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.space import StencilVectorSpace, resolve_device
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.hierarchy import (_kron_operator_from_1d,
                                         _kron_sum_band)
from poms_tpu_torch.models.bspline import (Spline1D, assemble_spline_1d,
                                           basis_funs, find_span,
                                           sin_moment_1d)

__all__ = ["PoissonProblem", "poisson_problem", "l2_error_manufactured"]


@dataclass
class PoissonProblem:
    dim: int
    degree: int
    n_el: Tuple[int, ...]
    space: StencilVectorSpace
    A: StencilMatrix | KroneckerSumOperator
    b: StencilVector
    splines: Tuple[Spline1D, ...]


def poisson_problem(dim: int, n_el, degree: int = 3,
                    dtype: torch.dtype = torch.float64,
                    operator: str = "banded", device=None) -> PoissonProblem:
    """Assemble the d-D Poisson system (stiffness A, manufactured b).

    ``operator="banded"`` materializes the full (2p+1)^d-per-point band on
    ``device``; ``"kron"`` keeps A in the O(n) Kronecker-sum form.
    ``device=None`` is the current CUDA card (an error when there is none);
    pass ``device="cpu"`` for the plain versions on the CPU.
    """
    device = resolve_device(device)
    if operator not in ("banded", "kron"):
        raise ValueError(f"operator={operator!r}: 'banded' or 'kron'")
    if isinstance(n_el, int):
        n_el = (n_el,) * dim
    n_el = tuple(int(x) for x in n_el)
    if len(n_el) != dim:
        raise ValueError(f"n_el {n_el} does not match dim {dim}")
    splines = tuple(assemble_spline_1d(ne, degree) for ne in n_el)
    space = StencilVectorSpace(npts=tuple(s.n for s in splines), pads=degree,
                               periodic=False, dtype=dtype, device=device)
    bands_1d = [(s.K, s.M) for s in splines]
    if operator == "kron":
        A = _kron_operator_from_1d(bands_1d, space)
    else:
        A = StencilMatrix.from_band_t(
            space, _kron_sum_band(bands_1d, dtype, space.device))
    # b = d π² ⊗_a s_a as a broadcast outer product (same order of
    # multiplies as the JAX package, so the f64 RHS is bitwise equal)
    moments = [torch.as_tensor(sin_moment_1d(s, m=1, interior=True),
                               dtype=dtype, device=device) for s in splines]
    b_int = moments[0]
    for m in moments[1:]:
        b_int = b_int[..., None] * m
    b_int = dim * np.pi ** 2 * b_int
    b = StencilVector.from_interior(space, b_int)
    return PoissonProblem(dim=dim, degree=degree, n_el=n_el, space=space,
                          A=A, b=b, splines=splines)


def _collocation_interior(sp: Spline1D, xs: np.ndarray) -> np.ndarray:
    """Dense (len(xs), n_interior) matrix of interior basis values at xs."""
    C = np.zeros((len(xs), sp.nb))
    for m, x in enumerate(xs):
        k = find_span(sp.knots, sp.degree, x)
        C[m, k - sp.degree:k + 1] = basis_funs(sp.knots, sp.degree, k, x)
    return C[:, 1:-1]


def l2_error_manufactured(problem: PoissonProblem, u: StencilVector,
                          pts_per_dim: int = 64) -> float:
    """L2 error of the discrete solution vs u = Π sin(π x_a) (host-side)."""
    d = problem.dim
    xs = (np.arange(pts_per_dim) + 0.5) / pts_per_dim  # midpoint rule
    Cs = [_collocation_interior(s, xs) for s in problem.splines]
    vals = u.interior.detach().to("cpu", torch.float64).numpy()
    for a in range(d):
        vals = np.tensordot(Cs[a], vals, axes=([1], [a]))
        vals = np.moveaxis(vals, 0, a)
    exact = np.sin(np.pi * xs)
    ex = exact
    for _ in range(d - 1):
        ex = np.multiply.outer(ex, exact)
    w = (1.0 / pts_per_dim) ** d
    return float(np.sqrt(np.sum((vals - ex) ** 2) * w))
