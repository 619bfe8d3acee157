"""Carry the JAX package's state into the port's objects.

The parity tests build a problem and a hierarchy in ``poms_tpu`` and run the
port on the same state.  The functions here take those objects duck-typed,
read their arrays with ``np.asarray`` (this module never imports jax) and
build the port's counterparts on ``device``.  Band tensors are converted
once per distinct source object, so the sharing structure of a
Kronecker-sum operator (which partial products are reused) is kept.
"""
from __future__ import annotations

import numpy as np
import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.hierarchy import Level
from poms_tpu_torch.models.bspline import Spline1D
from poms_tpu_torch.models.poisson import PoissonProblem
from poms_tpu_torch.ops.cholesky import DenseCholesky
from poms_tpu_torch.ops.transfer import TransferBand

__all__ = ["tensor", "space", "kron_operator", "stencil_matrix", "operator",
           "transfer_band", "cholesky", "levels", "problem", "lams"]


def tensor(a, device="cpu") -> torch.Tensor:
    """A host array (or anything ``np.asarray`` reads) as a torch tensor of
    the same dtype on ``device``."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(np_dtype))).dtype


def space(ref_space, device="cpu") -> StencilVectorSpace:
    return StencilVectorSpace(npts=ref_space.npts, pads=ref_space.pads,
                              periodic=ref_space.periodic,
                              dtype=_dtype(ref_space.dtype), device=device)


def kron_operator(ref_A, device="cpu") -> KroneckerSumOperator:
    """The operator of ``ref_A.terms`` with its band sharing kept."""
    seen = {}
    terms = []
    for term in ref_A.terms:
        row = []
        for B in term:
            if id(B) not in seen:
                seen[id(B)] = tensor(B, device)
            row.append(seen[id(B)])
        terms.append(row)
    return KroneckerSumOperator(space(ref_A.space, device), terms)


def stencil_matrix(ref_A, device="cpu") -> StencilMatrix:
    """The banded operator of ``ref_A.band_t`` (offset-major)."""
    return StencilMatrix(space(ref_A.space, device),
                         band_t=tensor(ref_A.band_t, device))


def operator(ref_A, device="cpu"):
    """A banded or Kronecker-sum operator, whichever ``ref_A`` is."""
    if hasattr(ref_A, "band_t"):
        return stencil_matrix(ref_A, device)
    return kron_operator(ref_A, device)


def transfer_band(tb, device="cpu") -> TransferBand:
    return TransferBand(w=tensor(tb.w, device),
                        c0=tensor(tb.c0, device).to(torch.int64),
                        n_in=int(tb.n_in))


def cholesky(ch, device="cpu") -> DenseCholesky:
    return DenseCholesky(L=tensor(ch.L, device))


def levels(ref_levels, device="cpu"):
    """Each level's operator, transfer bands and Cholesky factor."""
    def tbands(tbs):
        return None if tbs is None else tuple(transfer_band(tb, device)
                                              for tb in tbs)

    return [Level(A=operator(lev.A, device),
                  restrict=tbands(lev.restrict), prolong=tbands(lev.prolong),
                  chol=(None if lev.chol is None
                        else cholesky(lev.chol, device)))
            for lev in ref_levels]


def problem(ref_prob, device="cpu") -> PoissonProblem:
    """The problem's space, operator, padded RHS and 1D splines."""
    sp = space(ref_prob.space, device)
    splines = tuple(
        Spline1D(n_el=s.n_el, degree=s.degree, knots=np.asarray(s.knots),
                 nb=s.nb, n=s.n, K=np.asarray(s.K), M=np.asarray(s.M),
                 K_full=np.asarray(s.K_full), M_full=np.asarray(s.M_full))
        for s in ref_prob.splines)
    return PoissonProblem(dim=ref_prob.dim, degree=ref_prob.degree,
                          n_el=tuple(ref_prob.n_el), space=sp,
                          A=operator(ref_prob.A, device),
                          b=StencilVector(sp, tensor(ref_prob.b.data, device)),
                          splines=splines)


def lams(ref_lams):
    """The per-level λmax(D⁻¹A) tuple (None on the Cholesky level)."""
    return tuple(None if lam is None else float(lam) for lam in ref_lams)
