"""Kronecker-sum operators A = Σ_r B_r^(1) ⊗ … ⊗ B_r^(d).

Counterpart of ``poms_tpu.core.kron``.  Each B is a 1D stencil band
(n_a, 2p_a+1); for Poisson the d terms share their K and M band objects, and
the plain apply reuses partial products along that sharing.  The apply is K1
(:func:`poms_tpu_torch.ops.kron.kron_apply`): the CUDA kernel for tensors on
the card, the plain chain of 1D contractions for tensors on the CPU.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.ops.kron import apply_band_1d_axis, band_labels, kron_apply

__all__ = ["KroneckerSumOperator", "apply_band_1d_axis"]


def _band_to_dense(B: np.ndarray, pad: int, periodic: bool) -> np.ndarray:
    """Dense (n, n) matrix of a 1D band (clipped or wrapped diagonals)."""
    n = B.shape[0]
    D = np.zeros((n, n), dtype=B.dtype)
    rows = np.arange(n)
    for t in range(B.shape[1]):
        cols = rows + t - pad
        if periodic:
            np.add.at(D, (rows, cols % n), B[:, t])
        else:
            ok = (cols >= 0) & (cols < n)
            D[rows[ok], cols[ok]] += B[ok, t]
    return D


class KroneckerSumOperator:
    """A = Σ_r ⊗_a B_r^(a), each B a 1D stencil band (n_a, 2p_a+1)."""

    __slots__ = ("space", "terms")

    def __init__(self, space: StencilVectorSpace,
                 terms: Sequence[Sequence[torch.Tensor]]):
        self.space = space
        cast = {}   # one cast per distinct band: keeps the sharing labels

        def as_band(B):
            if id(B) not in cast:
                cast[id(B)] = torch.as_tensor(B, dtype=space.dtype,
                                              device=space.device)
            return cast[id(B)]

        self.terms = tuple(tuple(as_band(B) for B in term) for term in terms)
        for term in self.terms:
            if len(term) != space.ndim:
                raise ValueError("each term needs one 1D band per dim")
            for a, B in enumerate(term):
                if tuple(B.shape) != (space.npts[a], 2 * space.pads[a] + 1):
                    raise ValueError(
                        f"band {a} has shape {tuple(B.shape)}, expected "
                        f"{(space.npts[a], 2 * space.pads[a] + 1)}")

    def _band_labels(self):
        return band_labels(self.terms)

    def _apply_interior(self, x_int: torch.Tensor) -> torch.Tensor:
        return kron_apply(self.terms, x_int, self.space.npts, self.space.pads,
                          self.space.periodic)

    def dot(self, v: StencilVector) -> StencilVector:
        return StencilVector.from_interior(self.space,
                                           self._apply_interior(v.interior))

    def diagonal(self) -> torch.Tensor:
        """diag(Σ ⊗B) = Σ ⊗diag(B) — outer products of 1D diagonals."""
        out = None
        for term in self.terms:
            d = None
            for a, B in enumerate(term):
                d1 = B[:, self.space.pads[a]]
                d = d1 if d is None else torch.tensordot(d, d1, dims=0)
            out = d if out is None else out + d
        return out

    def toarray(self) -> np.ndarray:
        """Dense host matrix Σ_r ⊗_a dense(B_r^(a)), built with numpy."""
        total = None
        for term in self.terms:
            m = None
            for a, B in enumerate(term):
                D = _band_to_dense(B.detach().cpu().numpy(),
                                   self.space.pads[a], self.space.periodic[a])
                m = D if m is None else np.kron(m, D)
            total = m if total is None else total + m
        return total

    def transpose(self) -> "KroneckerSumOperator":
        """Aᵀ = Σ ⊗Bᵀ; 1D band transpose: Bt[i, k] = B[i+k-p, 2p-k]
        (row index wrapped on periodic dims)."""
        new = {}
        new_terms = []
        for term in self.terms:
            nt = []
            for a, B in enumerate(term):
                if id(B) not in new:
                    p, n = self.space.pads[a], self.space.npts[a]
                    Bh = B.detach().cpu().numpy()
                    Bt = np.zeros_like(Bh)
                    for k in range(2 * p + 1):
                        src = np.arange(n) + (k - p)
                        if self.space.periodic[a]:
                            Bt[:, k] = Bh[src % n, 2 * p - k]
                        else:
                            ok = (src >= 0) & (src < n)
                            Bt[ok, k] = Bh[src[ok], 2 * p - k]
                    new[id(B)] = torch.as_tensor(Bt, device=B.device)
                nt.append(new[id(B)])
            new_terms.append(nt)
        return KroneckerSumOperator(self.space, new_terms)

    def __repr__(self):
        return (f"KroneckerSumOperator(npts={self.space.npts}, "
                f"terms={len(self.terms)})")
