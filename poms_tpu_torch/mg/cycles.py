"""Multigrid cycles: V (γ=1), W (γ=2) and full multigrid (FMG).

Counterpart of ``poms_tpu.mg.cycles``: the recursion runs eagerly over the
level list; each smoothing sweep and residual goes through the level
operator (K2's fused passes on a banded level, K3's under
``POMS_TPU_SPMV=v2`` with the level's packed band; on a Kronecker-sum level
one K1 pass per Chebyshev step and per residual), transfers are banded
gathers (K7, one pass per axis), and the coarsest level is a pair of
triangular solves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.hierarchy import Level
from poms_tpu_torch.mg.smoother import SmootherConfig, smooth_step
from poms_tpu_torch.ops.transfer import apply_transfer

__all__ = ["CycleConfig", "cycle", "fmg"]


@dataclass(frozen=True)
class CycleConfig:
    nu1: int = 2                 # pre-smooth sweeps
    nu2: int = 2                 # post-smooth sweeps
    gamma: int = 1               # 1 = V-cycle, 2 = W-cycle
    smoother: SmootherConfig = field(default_factory=SmootherConfig)


def _coarse_solve(level: Level, b: StencilVector) -> StencilVector:
    sp = level.A.space
    x_flat = level.chol.solve(b.interior.reshape(-1))
    return StencilVector.from_interior(sp, x_flat.reshape(sp.npts))


def cycle(levels: List[Level], l: int, x: StencilVector, b: StencilVector,
          cfg: CycleConfig, lams=None) -> StencilVector:
    """One γ-cycle starting at level ``l`` (0 = finest)."""
    level = levels[l]
    lam = lams[l] if lams is not None else None
    if level.chol is not None:  # coarsest
        return _coarse_solve(level, b)
    for _ in range(cfg.nu1):
        x = smooth_step(level.A, x, b, cfg.smoother, lam_max=lam)
    r_int = level.A.residual(x, b)   # one fused pass: K2/K3, or K1 (kron)
    sp_c = levels[l + 1].A.space
    b_c = StencilVector.from_interior(sp_c,
                                      apply_transfer(level.restrict, r_int))
    x_c = StencilVector.zeros(sp_c)
    for _ in range(cfg.gamma):
        x_c = cycle(levels, l + 1, x_c, b_c, cfg, lams)
    # x + P·x_c, the sum formed in the last axis' transfer pass
    x = StencilVector.from_interior(
        level.A.space, apply_transfer(level.prolong, x_c.interior,
                                      add=x.interior))
    for _ in range(cfg.nu2):
        x = smooth_step(level.A, x, b, cfg.smoother, lam_max=lam)
    return x


def fmg(levels: List[Level], b: StencilVector, cfg: CycleConfig,
        cycles_per_level: int = 1, lams=None) -> StencilVector:
    """Full multigrid (nested iteration): coarsest solve, prolong, γ-cycle."""
    n = len(levels)
    bs = [b]
    for l in range(n - 1):
        b_c_int = apply_transfer(levels[l].restrict, bs[-1].interior)
        bs.append(StencilVector.from_interior(levels[l + 1].A.space, b_c_int))
    x = _coarse_solve(levels[-1], bs[-1])
    for l in range(n - 2, -1, -1):
        x_int = apply_transfer(levels[l].prolong, x.interior)
        x = StencilVector.from_interior(levels[l].A.space, x_int)
        for _ in range(cycles_per_level):
            x = cycle(levels, l, x, bs[l], cfg, lams)
    return x
