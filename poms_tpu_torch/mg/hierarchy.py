"""Multigrid hierarchy on Kronecker-sum operators.

Counterpart of the ``operator="kron"`` branch of ``poms_tpu.mg.hierarchy``:
per level, the dyadically coarsened spline space, the knot-insertion
prolongation P = ⊗ P1 (restriction R = Pᵀ), and the Galerkin coarse
operator, which for A = Σ ⊗K/M is Σ ⊗(P1ᵀKP1 / P1ᵀMP1): d small dense 1D
triple products on the host.  The coarsest level gets a dense Cholesky.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.models.bspline import prolongation_interior_1d
from poms_tpu_torch.ops.cholesky import DenseCholesky, factor_dense_cholesky
from poms_tpu_torch.ops.transfer import TransferBand, bands_from_dense

if TYPE_CHECKING:   # models.poisson builds its operator with this module
    from poms_tpu_torch.models.poisson import PoissonProblem

__all__ = ["Level", "build_hierarchy"]


@dataclass
class Level:
    """One multigrid level.  ``restrict``/``prolong`` map to/from the next
    coarser level and are None on the coarsest, where ``chol`` is set."""
    A: KroneckerSumOperator
    restrict: Optional[Tuple[TransferBand, ...]]
    prolong: Optional[Tuple[TransferBand, ...]]
    chol: Optional[DenseCholesky]


def _tensor_coarse_operator(splines, P1s, dim, degree) -> list:
    """Coarse per-dim (K_band, M_band): Pᵀ(Σ_a ⊗K/M)P = Σ_a ⊗(P1ᵀK P1 /
    P1ᵀM P1) since P = ⊗P1 — host numpy, the JAX package's arithmetic."""
    coarse_1d = []
    for s_pair, P1 in zip(splines, P1s):
        K_band, M_band = s_pair
        n = K_band.shape[0]
        p = degree

        def dense(Bb):
            D = np.zeros((n, n))
            for i in range(n):
                for off in range(2 * p + 1):
                    j = i + off - p
                    if 0 <= j < n:
                        D[i, j] = Bb[i, off]
            return D
        Kc = P1.T @ dense(K_band) @ P1
        Mc = P1.T @ dense(M_band) @ P1
        nc = P1.shape[1]
        Kcb = np.zeros((nc, 2 * p + 1))
        Mcb = np.zeros((nc, 2 * p + 1))
        for off in range(2 * p + 1):
            d_off = off - p
            i = np.arange(max(0, -d_off), min(nc, nc - d_off))
            Kcb[i, off] = Kc[i, i + d_off]
            Mcb[i, off] = Mc[i, i + d_off]
        scale = max(abs(Kc).max(), 1.0)
        mask = np.abs(np.triu(Kc, p + 1)) + np.abs(np.tril(Kc, -(p + 1)))
        if mask.max() > 1e-10 * scale:
            raise AssertionError("coarse 1D operator escaped the band")
        coarse_1d.append((Kcb, Mcb))
    return coarse_1d


def _kron_operator_from_1d(bands_1d, space: StencilVectorSpace):
    """Σ_a ⊗(K if dim == a else M) from per-dim (K, M) band pairs; the
    terms share band objects so the apply can reuse partials."""
    d = len(bands_1d)
    Ks = [torch.as_tensor(K, dtype=space.dtype, device=space.device)
          for K, _ in bands_1d]
    Ms = [torch.as_tensor(M, dtype=space.dtype, device=space.device)
          for _, M in bands_1d]
    terms = [[Ks[b] if b == a else Ms[b] for b in range(d)] for a in range(d)]
    return KroneckerSumOperator(space, terms)


def build_hierarchy(problem: PoissonProblem, num_levels: int,
                    operator: str = "kron"):
    """Levels finest→coarsest; each coarsening halves n_el per dim."""
    if operator != "kron":
        raise NotImplementedError(
            f"operator={operator!r}: banded hierarchies are ROADMAP slice 3")
    p, d, n_el = problem.degree, problem.dim, problem.n_el
    space = problem.space
    bands_1d = [(s.K, s.M) for s in problem.splines]
    A = _kron_operator_from_1d(bands_1d, space)
    levels = []
    for lev in range(num_levels - 1):
        if any(ne % 2 or ne < 2 for ne in n_el):
            raise ValueError(
                f"cannot coarsen n_el={n_el} at level {lev}: need even >= 2 "
                f"(asked for {num_levels} levels)")
        n_el_c = tuple(ne // 2 for ne in n_el)
        if any(nec + p - 2 < 1 for nec in n_el_c):
            raise ValueError(f"coarse space empty at level {lev + 1}")
        P1s = [prolongation_interior_1d(nec, p) for nec in n_el_c]
        prolong = tuple(bands_from_dense(P1, space.dtype, space.device)
                        for P1 in P1s)
        restrict = tuple(bands_from_dense(P1.T, space.dtype, space.device)
                         for P1 in P1s)
        bands_1d = _tensor_coarse_operator(bands_1d, P1s, d, p)
        coarse_space = StencilVectorSpace(
            npts=tuple(nec + p - 2 for nec in n_el_c), pads=(p,) * d,
            periodic=space.periodic, dtype=space.dtype, device=space.device)
        levels.append(Level(A=A, restrict=restrict, prolong=prolong,
                            chol=None))
        A = _kron_operator_from_1d(bands_1d, coarse_space)
        n_el = n_el_c
    levels.append(Level(A=A, restrict=None, prolong=None,
                        chol=factor_dense_cholesky(A)))
    return levels
