"""Periodic tensor-product problems (Helmholtz u − Δu, circulant splines).

Counterpart of ``poms_tpu.models.periodic``.  The periodic Laplacian has the
constant nullspace, so the periodic test problem is the shifted operator

    A = σ·(⊗M) + Σ_a M⊗…K_a…⊗M        (σ > 0 ⇒ SPD)

with circulant per-dim bands (``models/bspline.py::assemble_periodic_1d``)
and two-scale-relation transfers.  Everything under it takes periodic dims
already: the ghost wrap, the banded kernels K2/K3 (they read a ghost-padded
field), the index rule of K1 and K5.  This module adds the assembly and the
hierarchy, and returns the Level list the cycles consume.  The 1D bands, the
coarse 1D triple products and the right-hand side are host numpy, as in the
JAX package, so both packages hold the same numbers.

A periodic prolongation has wrapped rows, so its banded form is as wide as
the coarse axis (``ops/transfer.py::bands_from_dense`` returns W = n_in, in
both packages) and K7 then does n_in taps per point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator, kron_band_t
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.space import StencilVectorSpace, resolve_device
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.hierarchy import Level
from poms_tpu_torch.models.bspline import (assemble_periodic_1d,
                                           prolongation_periodic_1d)
from poms_tpu_torch.ops.cholesky import factor_dense_cholesky
from poms_tpu_torch.ops.transfer import bands_from_dense

__all__ = ["PeriodicProblem", "periodic_problem",
           "build_periodic_hierarchy"]


@dataclass
class PeriodicProblem:
    dim: int
    degree: int
    n_el: Tuple[int, ...]
    shift: float
    space: StencilVectorSpace
    A: StencilMatrix
    b: StencilVector
    bands_1d: list  # per-dim (K, M) numpy circulant bands


def _factors(bands_1d, space):
    Ks = [torch.as_tensor(b[0], dtype=space.dtype, device=space.device)
          for b in bands_1d]
    Ms = [torch.as_tensor(b[1], dtype=space.dtype, device=space.device)
          for b in bands_1d]
    return Ks, Ms


def _band_from_1d(bands_1d, shift, space) -> torch.Tensor:
    """Offset-major band of σ·⊗M + Σ_a ⊗(K/M), composed on the device in the
    JAX package's order: the shift scales the outer product of the mass
    bands, then the stiffness terms are added one by one."""
    d = len(bands_1d)
    Ks, Ms = _factors(bands_1d, space)
    total = shift * kron_band_t([Ms])
    for a in range(d):
        total += kron_band_t([[Ks[b] if b == a else Ms[b]
                               for b in range(d)]])
    return total


def periodic_problem(dim: int, n_el, degree: int = 3, shift: float = 1.0,
                     dtype: torch.dtype = torch.float64, seed: int = 0,
                     device=None) -> PeriodicProblem:
    """Assemble the periodic shifted-Laplace system with a random right-hand
    side drawn from ``np.random.default_rng(seed)``.  ``device=None`` is the
    current CUDA card (an error when there is none)."""
    device = resolve_device(device)
    if isinstance(n_el, int):
        n_el = (n_el,) * dim
    n_el = tuple(int(x) for x in n_el)
    bands_1d = [assemble_periodic_1d(ne, degree) for ne in n_el]
    space = StencilVectorSpace(npts=n_el, pads=degree, periodic=True,
                               dtype=dtype, device=device)
    A = StencilMatrix.from_band_t(space, _band_from_1d(bands_1d, shift, space))
    rng = np.random.default_rng(seed)
    b = StencilVector.from_interior(
        space, torch.as_tensor(rng.standard_normal(n_el)))
    return PeriodicProblem(dim=dim, degree=degree, n_el=n_el, shift=shift,
                           space=space, A=A, b=b, bands_1d=bands_1d)


def _coarse_bands_periodic(bands_1d, P1s):
    """1D circulant Galerkin RAP: dense triple product + wrapped band
    extraction (periodic nested spaces keep the 2p+1 band).  Host numpy, the
    JAX package's arithmetic."""
    out = []
    for (Kb, Mb), P1 in zip(bands_1d, P1s):
        n = Kb.shape[0]
        p = (Kb.shape[1] - 1) // 2

        def dense(Bb):
            D = np.zeros((n, n))
            for off in range(2 * p + 1):
                cols = (np.arange(n) + off - p) % n
                D[np.arange(n), cols] += Bb[:, off]
            return D

        nc = P1.shape[1]
        Kc = P1.T @ dense(Kb) @ P1
        Mc = P1.T @ dense(Mb) @ P1
        Kcb = np.zeros((nc, 2 * p + 1))
        Mcb = np.zeros((nc, 2 * p + 1))
        for off in range(2 * p + 1):
            cols = (np.arange(nc) + off - p) % nc
            Kcb[:, off] = Kc[np.arange(nc), cols]
            Mcb[:, off] = Mc[np.arange(nc), cols]
        escaped = abs(np.abs(Kc).sum() - np.abs(Kcb).sum())
        if escaped > 1e-8 * max(np.abs(Kc).sum(), 1.0):
            raise AssertionError("periodic coarse operator escaped the band")
        out.append((Kcb, Mcb))
    return out


def _kron_periodic(bands_1d, shift, space) -> KroneckerSumOperator:
    """σ·⊗M + Σ_a ⊗(K_a in slot a) as a Kronecker-sum operator: σ folded
    into the first M factor of the shift term, the M bands shared across the
    terms so the apply reuses partial products."""
    d = len(bands_1d)
    Ks, Ms = _factors(bands_1d, space)
    shift_term = [shift * Ms[0]] + [Ms[b] for b in range(1, d)]
    terms = [shift_term] + [[Ks[b] if b == a else Ms[b] for b in range(d)]
                            for a in range(d)]
    return KroneckerSumOperator(space, terms)


def build_periodic_hierarchy(problem: PeriodicProblem, num_levels: int,
                             operator: str = "banded"):
    """Levels finest→coarsest for the periodic shifted-Laplace problem; each
    coarsening halves n_el per dim (even, with n/2 > 2p).  Under the v2
    engine every banded level packs its band for K3 here."""
    if operator not in ("banded", "kron"):
        raise ValueError(f"operator={operator!r}: 'banded' or 'kron'")
    p, d, n_el = problem.degree, problem.dim, problem.n_el
    bands_1d = problem.bands_1d
    space = problem.space
    A = problem.A
    if operator == "kron":
        A = _kron_periodic(bands_1d, problem.shift, space)
    levels = []
    for _ in range(num_levels - 1):
        if any(ne % 2 or ne // 2 <= 2 * p for ne in n_el):
            raise ValueError(f"cannot coarsen periodic n_el={n_el} "
                             f"(need even with n/2 > 2p)")
        n_el_c = tuple(ne // 2 for ne in n_el)
        P1s = [prolongation_periodic_1d(nec, p) for nec in n_el_c]
        prolong = tuple(bands_from_dense(P1, space.dtype, space.device)
                        for P1 in P1s)
        restrict = tuple(bands_from_dense(P1.T, space.dtype, space.device)
                         for P1 in P1s)
        bands_1d = _coarse_bands_periodic(bands_1d, P1s)
        coarse_space = StencilVectorSpace(
            npts=n_el_c, pads=(p,) * d, periodic=True, dtype=space.dtype,
            device=space.device)
        if operator == "kron":
            A_c = _kron_periodic(bands_1d, problem.shift, coarse_space)
        else:
            A_c = StencilMatrix.from_band_t(
                coarse_space,
                _band_from_1d(bands_1d, problem.shift, coarse_space))
        levels.append(Level(A=A, restrict=restrict, prolong=prolong,
                            chol=None))
        A, n_el = A_c, n_el_c
    levels.append(Level(A=A, restrict=None, prolong=None,
                        chol=factor_dense_cholesky(A)))
    for lev in levels:
        if isinstance(lev.A, StencilMatrix):
            lev.A.ensure_packed_v2()
    return levels
