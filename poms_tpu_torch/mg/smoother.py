"""Smoothers: weighted Jacobi, red-black and lexicographic Gauss–Seidel,
and Chebyshev.

Counterpart of ``poms_tpu.mg.smoother``.  Every smoother takes a banded
:class:`StencilMatrix` or a generic operator (a
:class:`KroneckerSumOperator`); on a banded operator the Jacobi sweep, the
red-black colour phases and the Chebyshev residuals are single fused K2
passes (:mod:`poms_tpu_torch.ops.dispatch`), or K3 passes over the
operator's packed band under ``POMS_TPU_SPMV=v2``.

Update rules (the semantics the JAX package and its oracle define):

- ``jacobi``:  x ← x + ω D⁻¹ (b − A x)
- ``rbgs``:    for colour c in (red = 0, black = 1):
                 x[c] ← (1−ω) x[c] + ω D⁻¹ (b − (A x)_offdiag)[c]
  with the current x (the black phase sees this sweep's red update).  For
  wide stencils (p ≥ 2) same-colour neighbours contribute their pre-phase
  values: a colour phase is out of place.
- ``gs_lex``:  lexicographic Gauss–Seidel/SOR, a sequential loop over the
  rows (a parity path only: red-black is the parallel smoother).
- ``chebyshev``: degree-k Chebyshev on D⁻¹A over [λmax/fraction, λmax],
  λmax(D⁻¹A) from an f32 power iteration at setup.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.ops import dispatch
from poms_tpu_torch.ops.stencil import color_mask

__all__ = ["SmootherConfig", "estimate_dinv_a_lambda_max",
           "attach_spectral_estimates", "resolve_omega", "color_mask",
           "jacobi_step", "rbgs_step", "gs_lex_step", "chebyshev_step",
           "smooth_step"]


@dataclass(frozen=True)
class SmootherConfig:
    kind: str = "jacobi"        # 'jacobi' | 'rbgs' | 'gs_lex' | 'chebyshev'
    omega: float | None = None  # damping / SOR factor; None = automatic
    cheb_degree: int = 4        # polynomial degree for 'chebyshev'
    cheb_fraction: float = 4.0  # smooth [λmax/fraction, λmax]


def _banded(A) -> bool:
    return isinstance(A, StencilMatrix)


def _cast_operator_f32(A):
    """f32 copy of a banded or Kronecker-sum operator (setup-time only)."""
    sp32 = A.space.with_dtype(torch.float32)
    if _banded(A):
        return StencilMatrix(sp32, band_t=A.band_t.to(torch.float32)
                             ).ensure_packed_v2()
    return KroneckerSumOperator(sp32, A.terms)


def estimate_dinv_a_lambda_max(A, iters: int = 30, seed: int = 0) -> float:
    """Power-method estimate of λmax(D⁻¹A), in f32 for any operator dtype.

    The start vector is drawn on the host from a ``torch.Generator`` seeded
    with ``seed`` (the same vector on every device) and moved to the card.
    """
    if A.space.dtype != torch.float32:
        A = _cast_operator_f32(A)
    sp = A.space
    generator = torch.Generator().manual_seed(seed)
    x = torch.randn(sp.npts, generator=generator,
                    dtype=torch.float32).to(sp.device)
    if _banded(A):
        diag = A.diagonal()

        def step(x):
            return A.dot(StencilVector.from_interior(sp, x)).interior / diag
    else:
        step = A.dinv_apply     # one K1 pass, the diagonal formed in it
    x = x / torch.linalg.vector_norm(x)
    for _ in range(iters):
        y = step(x)
        x = y / torch.linalg.vector_norm(y)
    y = step(x)
    return float(torch.vdot(x.reshape(-1), y.reshape(-1))
                 / torch.vdot(x.reshape(-1), x.reshape(-1)))


def resolve_omega(cfg: SmootherConfig, A) -> SmootherConfig:
    """Fill in an automatic damping factor when omega is None: ω = 1 for
    the Gauss–Seidel smoothers, (4/3)/λmax(D⁻¹A) (at most 1) for Jacobi."""
    if cfg.omega is not None or cfg.kind == "chebyshev":
        return cfg
    if cfg.kind in ("rbgs", "gs_lex"):
        return replace(cfg, omega=1.0)
    lam = estimate_dinv_a_lambda_max(A) * 1.05  # safety margin
    return replace(cfg, omega=min(4.0 / 3.0 / lam, 1.0))


def attach_spectral_estimates(levels, cfg: SmootherConfig):
    """Per-level λmax(D⁻¹A) estimates (tuple of floats, coarsest None)."""
    if cfg.kind != "chebyshev":
        return tuple(None for _ in levels)
    return tuple(None if lev.chol is not None
                 else estimate_dinv_a_lambda_max(lev.A) * 1.02
                 for lev in levels)


def jacobi_step(A, x: StencilVector, b: StencilVector,
                omega: float) -> StencilVector:
    """x ← x + ω D⁻¹ (b − A x): one fused K2 pass on a banded operator."""
    sp = A.space
    if _banded(A):
        x_new = dispatch.jacobi(A.band_t, x.update_ghost_regions().data,
                                b.interior, omega, sp.npts, sp.pads,
                                packed=A.packed_v2)
        return StencilVector.from_interior(sp, x_new)
    x_new = x.interior + omega * A.residual(x, b) / A.diagonal()
    return StencilVector.from_interior(sp, x_new)


def rbgs_step(A, x: StencilVector, b: StencilVector, omega: float,
              starts: Optional[Tuple[int, ...]] = None) -> StencilVector:
    """One red-black sweep (red, then black); ``starts`` are the field's
    global index offsets, which decide each point's colour."""
    sp = A.space
    if _banded(A):   # one fused K2 pass per colour
        for color in (0, 1):
            x_new = dispatch.rbgs_color(
                A.band_t, x.update_ghost_regions().data, b.interior, omega,
                color, sp.npts, sp.pads, starts, packed=A.packed_v2)
            x = StencilVector.from_interior(sp, x_new)
        return x
    diag = A.diagonal()
    for color in (0, 1):
        mask = color_mask(sp.npts, color, starts, device=sp.device)
        s = A.dot(x).interior - diag * x.interior  # offdiag = A x − diag·x
        gs_val = (b.interior - s) / diag
        x_new = torch.where(mask, (1.0 - omega) * x.interior + omega * gs_val,
                            x.interior)
        x = StencilVector.from_interior(sp, x_new)
    return x


def gs_lex_step(A: StencilMatrix, x: StencilVector, b: StencilVector,
                omega: float) -> StencilVector:
    """Sequential lexicographic SOR sweep (non-periodic only).

    One host loop over the rows in C order, each row reading the current x
    (updated rows before it, old rows after it): a parity path for small
    problems, one row at a time."""
    sp = A.space
    if any(sp.periodic):
        raise NotImplementedError("gs_lex requires non-periodic boundaries")
    x_pad = x.update_ghost_regions().data.clone()
    band_t, b_int, diag = A.band_t, b.interior, A.diagonal()
    win = sp.band_shape
    centre = tuple(sp.pads)
    for idx in itertools.product(*[range(n) for n in sp.npts]):
        window = x_pad[tuple(slice(i, i + w) for i, w in zip(idx, win))]
        row = band_t[(Ellipsis,) + idx]
        s = torch.sum(row * window) - row[centre] * window[centre]
        new = (1.0 - omega) * window[centre] + omega * (b_int[idx] - s) \
            / diag[idx]
        x_pad[tuple(i + p for i, p in zip(idx, sp.pads))] = new
    return StencilVector(sp, x_pad)


def chebyshev_step(A, x: StencilVector, b: StencilVector,
                   lam_max: float, degree: int = 4,
                   fraction: float = 4.0) -> StencilVector:
    """One degree-k Chebyshev smoothing application on D⁻¹A over
    [λmax/fraction, λmax]: ``degree`` operator applies (fused K2
    residuals on a banded operator; on a Kronecker-sum operator each step
    is one K1 pass in its ``cheb`` mode and nothing else)."""
    sp = A.space
    lam_min = lam_max / fraction
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    if not _banded(A):
        return _chebyshev_kron(A, x, b, theta, delta, degree)
    diag = A.diagonal()
    z = A.residual(x, b) / diag
    d = z / theta
    x = StencilVector.from_interior(sp, x.interior + d)
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        z = A.residual(x, b) / diag
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = StencilVector.from_interior(sp, x.interior + d)
        rho = rho_new
    return x


def _chebyshev_kron(A, x: StencilVector, b: StencilVector, theta: float,
                    delta: float, degree: int) -> StencilVector:
    """The Chebyshev recurrence with its scalars on the host: step k is
    x ← x + d, d ← c1·d + c2·D⁻¹(b − A x), (c1, c2) = (0, 1/θ) first.  The
    x iterates alternate between two buffers (a step still reads its
    input's neighbours); the caller's x is never written."""
    b_int = b.interior
    sigma = theta / delta
    rho = 1.0 / sigma
    coeffs = [(0.0, 1.0 / theta)]
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    x_int, d, spare = x.interior, None, None
    for k, (c1, c2) in enumerate(coeffs):
        x_new, d = A.cheb_update(x_int, b_int, d, c1, c2, out=spare)
        spare = x_int if k > 0 else None
        x_int = x_new
    return StencilVector.from_interior(A.space, x_int)


def smooth_step(A, x: StencilVector, b: StencilVector, cfg: SmootherConfig,
                starts: Optional[Tuple[int, ...]] = None,
                lam_max: float | None = None) -> StencilVector:
    if cfg.kind == "jacobi":
        return jacobi_step(A, x, b, cfg.omega)
    if cfg.kind == "chebyshev":
        if lam_max is None:
            raise ValueError("chebyshev smoother needs a per-level lam_max "
                             "(attach_spectral_estimates)")
        return chebyshev_step(A, x, b, lam_max, cfg.cheb_degree,
                              cfg.cheb_fraction)
    if cfg.kind == "rbgs":
        return rbgs_step(A, x, b, cfg.omega, starts)
    if cfg.kind == "gs_lex":
        if not _banded(A):
            raise NotImplementedError("gs_lex needs the banded format")
        return gs_lex_step(A, x, b, cfg.omega)
    raise ValueError(f"unknown smoother {cfg.kind!r}")
