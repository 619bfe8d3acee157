"""Kronecker-sum operators A = Σ_r B_r^(1) ⊗ … ⊗ B_r^(d).

Counterpart of ``poms_tpu.core.kron``.  Each B is a 1D stencil band
(n_a, 2p_a+1); for Poisson the d terms share their K and M band objects, and
the plain apply reuses partial products along that sharing.  The apply, the
residual, the D⁻¹-scaled apply and the Chebyshev update are the modes of K1
(:func:`poms_tpu_torch.ops.kron.kron_mode`): the CUDA kernel for tensors on
the card, the plain chain of 1D contractions for tensors on the CPU.  The
kernel's launch data (stacked bands, sharing plan, tiling) is built once,
when the operator is made.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.ops.kron import (apply_band_1d_axis, band_labels,
                                     build_kron_plan, kron_mode)

__all__ = ["KroneckerSumOperator", "apply_band_1d_axis", "kron_band_t"]


def kron_band_t(terms) -> torch.Tensor:
    """Offset-major band (offsets..., grid...) of Σ_r ⊗_a B_r^(a) from the
    1D bands (n_a, 2p_a+1), composed on their device with ``torch.einsum``.

    The d-D band is GB-scale for 3D problems (5.9 GB at 129³ p3 in f64), so
    it is never built on the host, the einsum emits the offset-major layout
    directly, and each term is added into the total in place: the peak is
    two bands, not one per term.
    """
    d = len(terms[0])
    in_subs = [chr(ord("a") + b) + chr(ord("n") + b) for b in range(d)]
    expr = (",".join(in_subs) + "->"
            + "".join(chr(ord("n") + b) for b in range(d))
            + "".join(chr(ord("a") + b) for b in range(d)))
    total = None
    for term in terms:
        t = torch.einsum(expr, *term)
        if total is None:
            total = t.contiguous()
        else:
            total += t
        del t
    return total


class KroneckerSumOperator:
    """A = Σ_r ⊗_a B_r^(a), each B a 1D stencil band (n_a, 2p_a+1)."""

    __slots__ = ("space", "terms", "plan")

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
        self.plan = build_kron_plan(self.terms, space.npts, space.pads,
                                    space.periodic)

    def _band_labels(self):
        return band_labels(self.terms)

    def _mode(self, mode: str, x_int: torch.Tensor, **kw):
        return kron_mode(mode, self.plan, x_int, **kw)

    def _apply_interior(self, x_int: torch.Tensor) -> torch.Tensor:
        return self._mode("apply", x_int)

    def dot(self, v: StencilVector) -> StencilVector:
        return StencilVector.from_interior(self.space,
                                           self._apply_interior(v.interior))

    def residual(self, x: StencilVector, b: StencilVector) -> torch.Tensor:
        """Interior of b − A x: one K1 pass."""
        return self._mode("residual", x.interior, b=b.interior)

    def dinv_apply(self, x_int: torch.Tensor) -> torch.Tensor:
        """(A x) / diag(A) on an interior field: one K1 pass (the power
        iteration's step)."""
        return self._mode("dinv", x_int)

    def cheb_update(self, x_int: torch.Tensor, b_int: torch.Tensor, d,
                    c1: float, c2: float, out=None):
        """One Chebyshev update in one K1 pass: z = (b − A x)/diag(A),
        d ← c1·d + c2·z (``d=None``: d = c2·z), returns (x + d, d).  On the
        card ``d`` is updated in place and ``out`` may name the buffer of
        the result."""
        return self._mode("cheb", x_int, b=b_int, d=d, c1=c1, c2=c2, out=out)

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

    # -- conversions --------------------------------------------------------
    def to_stencil(self) -> StencilMatrix:
        """Exact conversion to the general banded format."""
        return StencilMatrix.from_band_t(self.space, kron_band_t(self.terms))

    def tocsr(self):
        return self.to_stencil().tocsr()

    def toarray(self) -> np.ndarray:
        """Dense host matrix, through the banded format (as the JAX
        package's)."""
        return self.to_stencil().toarray()

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

    @property
    def T(self) -> "KroneckerSumOperator":
        return self.transpose()

    def __repr__(self):
        return (f"KroneckerSumOperator(npts={self.space.npts}, "
                f"terms={len(self.terms)})")
