"""Carry the JAX package's state into the port's objects.

The parity tests build a problem and a hierarchy in ``poms_tpu`` and run the
port on the same state.  The functions here take those objects duck-typed,
read their arrays with ``np.asarray`` (this module never imports jax) and
build the port's counterparts on ``device``.  Band tensors are converted
once per distinct source object, so the sharing structure of a
Kronecker-sum operator (which partial products are reused) is kept.  A bf16
hierarchy and a periodic problem or hierarchy are carried across like any
other.
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
from poms_tpu_torch.models.periodic import PeriodicProblem
from poms_tpu_torch.models.poisson import PoissonProblem
from poms_tpu_torch.ops.cholesky import DenseCholesky
from poms_tpu_torch.ops.transfer import TransferBand, bands_from_dense

__all__ = ["tensor", "space", "kron_operator", "stencil_matrix", "operator",
           "transfer_band", "cholesky", "levels", "problem", "lams",
           "cycle_config", "mixed_precision_mg"]


def _is_bf16(np_dtype) -> bool:
    return np.dtype(np_dtype).name == "bfloat16"


def tensor(a, device="cpu") -> torch.Tensor:
    """A host array (or anything ``np.asarray`` reads) as a torch tensor of
    the same dtype on ``device``.  numpy has no bfloat16 of its own, so a
    bf16 array goes through f32 (exact: every bf16 value is an f32 value)
    and is cast back to ``torch.bfloat16`` (exact again)."""
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _dtype(np_dtype) -> torch.dtype:
    if _is_bf16(np_dtype):
        return torch.bfloat16
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
    """The band as it is, or, where its rows wrap around the end of the axis
    (the JAX package bands a periodic transfer as wide as the axis), the
    port's narrower wrapped band of the same matrix."""
    w, c0, n_in = tensor(tb.w, device), np.asarray(tb.c0), int(tb.n_in)
    dense = np.zeros((w.shape[0], n_in))
    cols = (c0[:, None] + np.arange(w.shape[1])) % n_in
    dense[np.arange(w.shape[0])[:, None], cols] = \
        w.to(torch.float64).cpu().numpy()
    wrapped = bands_from_dense(dense, w.dtype, device)
    if wrapped.wrap:
        return wrapped
    return TransferBand(w=w, c0=tensor(c0, device).to(torch.int64),
                        n_in=n_in)


def cholesky(ch, device="cpu") -> DenseCholesky:
    """The factor as it is; a bf16 factor cast up to f32 (exact), since the
    port's bf16 levels solve in f32 (``ops/cholesky.py``)."""
    L = tensor(ch.L, device)
    return DenseCholesky(L=L.to(torch.float32) if L.dtype == torch.bfloat16
                         else L)


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


def problem(ref_prob, device="cpu"):
    """The problem's space, operator, padded RHS and 1D splines; a
    ``PeriodicProblem`` (it has a ``shift``) with its per-dim (K, M) bands."""
    sp = space(ref_prob.space, device)
    if hasattr(ref_prob, "shift"):
        return PeriodicProblem(
            dim=ref_prob.dim, degree=ref_prob.degree,
            n_el=tuple(ref_prob.n_el), shift=float(ref_prob.shift), space=sp,
            A=operator(ref_prob.A, device),
            b=StencilVector(sp, tensor(ref_prob.b.data, device)),
            bands_1d=[(np.array(K), np.array(M))
                      for K, M in ref_prob.bands_1d])
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


def cycle_config(ref_cfg):
    """The port's CycleConfig of a reference one (field by field)."""
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig

    sm = ref_cfg.smoother
    return CycleConfig(
        nu1=ref_cfg.nu1, nu2=ref_cfg.nu2, gamma=ref_cfg.gamma,
        smoother=SmootherConfig(kind=sm.kind, omega=sm.omega,
                                cheb_degree=sm.cheb_degree,
                                cheb_fraction=sm.cheb_fraction))


def mixed_precision_mg(ref_mg, ref_lams, device="cpu"):
    """A reference ``MixedPrecisionMG`` as the port's, with the reference's
    state instead of a setup of its own: ``levels64``, ``levels32`` (the
    reference's cast arrays), the split bands ``_terms_df`` of the twofloat
    mode, and ``ref_lams``, the reference's λmax(D⁻¹A) estimates
    (``attach_spectral_estimates(ref_mg.levels64, ref_mg.cfg.smoother)``;
    the reference keeps them in a closure)."""
    from poms_tpu_torch.mg.mixed import MixedPrecisionMG
    from poms_tpu_torch.ops.twofloat import build_kron_df_plan

    mg = MixedPrecisionMG.__new__(MixedPrecisionMG)
    mg.residual_mode = ref_mg.residual_mode
    mg.inner_cycles = int(ref_mg.inner_cycles)
    mg.problem = problem(ref_mg.problem, device)
    mg.levels64 = levels(ref_mg.levels64, device)
    mg.levels32 = levels(ref_mg.levels32, device)
    mg.low_dtype = mg.levels32[0].A.space.dtype
    mg.cfg = cycle_config(ref_mg.cfg)
    mg.lams = lams(ref_lams)
    if mg.residual_mode == "twofloat":
        seen = {}
        terms_df = []
        for term in ref_mg._terms_df:
            row = []
            for pair in term:
                if id(pair) not in seen:
                    seen[id(pair)] = (tensor(pair[0], device),
                                      tensor(pair[1], device))
                row.append(seen[id(pair)])
            terms_df.append(tuple(row))
        mg._terms_df = tuple(terms_df)
        mg._labels = mg.levels64[0].A._band_labels()
        sp = mg.problem.space
        mg._plan_df = build_kron_df_plan(mg._terms_df, sp.npts, sp.pads,
                                         sp.periodic, mg._labels)
    return mg
