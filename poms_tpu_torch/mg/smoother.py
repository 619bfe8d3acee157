"""Smoothers on generic (Kronecker-sum) operators: Chebyshev and Jacobi.

Counterpart of ``poms_tpu.mg.smoother`` for operators without an assembled
band.  The production smoother is degree-k Chebyshev on D⁻¹A over
[λmax/fraction, λmax], with λmax(D⁻¹A) from an f32 power iteration at setup.
The red-black and lexicographic Gauss–Seidel sweeps need the banded format
(ROADMAP slice 3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.vector import StencilVector

__all__ = ["SmootherConfig", "estimate_dinv_a_lambda_max",
           "attach_spectral_estimates", "resolve_omega", "chebyshev_step",
           "jacobi_step", "smooth_step"]


@dataclass(frozen=True)
class SmootherConfig:
    kind: str = "jacobi"        # 'jacobi' | 'chebyshev'
    omega: float | None = None  # damping; None = (4/3)/λmax from setup
    cheb_degree: int = 4        # polynomial degree for 'chebyshev'
    cheb_fraction: float = 4.0  # smooth [λmax/fraction, λmax]


def estimate_dinv_a_lambda_max(A, iters: int = 30, seed: int = 0) -> float:
    """Power-method estimate of λmax(D⁻¹A), in f32 for any operator dtype.

    The start vector is drawn on the host from a ``torch.Generator`` seeded
    with ``seed`` (the same vector on every device) and moved to the card.
    """
    sp = A.space.with_dtype(torch.float32)
    A = KroneckerSumOperator(sp, A.terms)
    generator = torch.Generator().manual_seed(seed)
    x = torch.randn(sp.npts, generator=generator,
                    dtype=torch.float32).to(sp.device)
    diag = A.diagonal()
    x = x / torch.linalg.vector_norm(x)
    for _ in range(iters):
        y = A._apply_interior(x) / diag
        x = y / torch.linalg.vector_norm(y)
    y = A._apply_interior(x) / diag
    return float(torch.vdot(x.reshape(-1), y.reshape(-1))
                 / torch.vdot(x.reshape(-1), x.reshape(-1)))


def resolve_omega(cfg: SmootherConfig, A) -> SmootherConfig:
    """Fill in an automatic damping factor when omega is None."""
    if cfg.omega is not None or cfg.kind == "chebyshev":
        return cfg
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
    """x ← x + ω D⁻¹ (b − A x) for a generic operator."""
    r = b.interior - A.dot(x).interior
    x_new = x.interior + omega * r / A.diagonal()
    return StencilVector.from_interior(A.space, x_new)


def chebyshev_step(A, x: StencilVector, b: StencilVector,
                   lam_max: float, degree: int = 4,
                   fraction: float = 4.0) -> StencilVector:
    """One degree-k Chebyshev smoothing application on D⁻¹A over
    [λmax/fraction, λmax]: ``degree`` operator applies."""
    sp = A.space
    lam_min = lam_max / fraction
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    diag = A.diagonal()

    def resid(xv):
        return b.interior - A.dot(xv).interior

    z = resid(x) / diag
    d = z / theta
    x = StencilVector.from_interior(sp, x.interior + d)
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        z = resid(x) / diag
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = StencilVector.from_interior(sp, x.interior + d)
        rho = rho_new
    return x


def smooth_step(A, x: StencilVector, b: StencilVector, cfg: SmootherConfig,
                lam_max: float | None = None) -> StencilVector:
    if cfg.kind == "jacobi":
        return jacobi_step(A, x, b, cfg.omega)
    if cfg.kind == "chebyshev":
        if lam_max is None:
            raise ValueError("chebyshev smoother needs a per-level lam_max "
                             "(attach_spectral_estimates)")
        return chebyshev_step(A, x, b, lam_max, cfg.cheb_degree,
                              cfg.cheb_fraction)
    if cfg.kind in ("rbgs", "gs_lex"):
        raise NotImplementedError(
            f"smoother {cfg.kind!r} needs the banded format (ROADMAP slice 3)")
    raise ValueError(f"unknown smoother {cfg.kind!r}")
