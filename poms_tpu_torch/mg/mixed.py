"""MG-preconditioned CG with mixed-precision recurrences.

Counterpart of ``MGPreconditionedCG`` in ``poms_tpu.mg.mixed``: flexible CG
(IPCG / Polak–Ribière β, which tolerates the slightly nonsymmetric f32
preconditioner) with one multigrid cycle as the preconditioner.

- ``precision="dw"``: x and r are double-word f32 pairs, A·p is the
  double-word Kronecker apply, directions and the V-cycle are f32, and
  α, β, ρ are f64 scalars on the device.  Needs ``mixed=True`` and
  ``operator="kron"``.
- ``precision="f64"``: the recurrences in f64, the cycle in f32 when
  ``mixed`` (else in f64); banded (K2) or Kronecker-sum (K1) levels.

``solve`` is the host loop with its residual history; ``solve_compiled``
runs the same iterations without the history and returns ``(x, rn, it)``.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional

import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig, cycle
from poms_tpu_torch.mg.hierarchy import Level, build_hierarchy
from poms_tpu_torch.mg.smoother import attach_spectral_estimates, resolve_omega
from poms_tpu_torch.mg.solver import SolveResult
from poms_tpu_torch.models.poisson import PoissonProblem
from poms_tpu_torch.ops.cholesky import DenseCholesky
from poms_tpu_torch.ops.transfer import TransferBand
from poms_tpu_torch.ops.twofloat import (build_kron_df_plan, dw_add, dw_dot,
                                         dw_dot_stack, dw_mul, dw_norm2,
                                         merge_f64, residual_kron_df,
                                         split_f64)

__all__ = ["MGPreconditionedCG", "MixedPrecisionMG"]


def _cast_levels(levels, dtype: torch.dtype):
    """Cast a hierarchy's bands, transfer weights and Cholesky factor.

    Each distinct tensor is cast once (keyed by identity), so the terms of
    a cast Kronecker-sum operator share band objects as the originals did."""
    cast = {}

    def c(t):
        if id(t) not in cast:
            cast[id(t)] = t.to(dtype)
        return cast[id(t)]

    def tbands(tbs):
        return None if tbs is None else tuple(
            TransferBand(w=c(tb.w), c0=tb.c0, n_in=tb.n_in) for tb in tbs)

    out = []
    for lev in levels:
        sp = lev.A.space.with_dtype(dtype)
        if isinstance(lev.A, StencilMatrix):   # packed for K3 under v2
            A = StencilMatrix(sp, band_t=c(lev.A.band_t)).ensure_packed_v2()
        else:
            A = KroneckerSumOperator(
                sp, [[c(B) for B in term] for term in lev.A.terms])
        chol = None if lev.chol is None else DenseCholesky(L=c(lev.chol.L))
        out.append(Level(A=A, restrict=tbands(lev.restrict),
                         prolong=tbands(lev.prolong), chol=chol))
    return out


def _safe(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, scale, torch.ones_like(scale))


class MixedPrecisionMG:
    """Defect-correction multigrid: ROADMAP slice 2 (not in this port yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MixedPrecisionMG is ROADMAP slice 2, item 16 "
            "(defect correction with twofloat/f64 residuals)")


class MGPreconditionedCG:
    """Flexible CG (IPCG) with one multigrid cycle as preconditioner.

    ``lams`` holds the per-level λmax(D⁻¹A) estimates; the preconditioner
    reads it at every call, so it may be replaced after construction.
    """

    def __init__(self, problem: PoissonProblem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(), mixed: bool = True,
                 low_dtype: torch.dtype = torch.float32,
                 operator: str = "banded", precision: str = "f64"):
        if precision == "dwrr":
            raise NotImplementedError(
                "precision='dwrr' (residual-replacement PCG) is ROADMAP "
                "slice 2, item 16")
        if precision not in ("f64", "dw"):
            raise ValueError(f"precision={precision!r}")
        if precision == "dw" and operator != "kron":
            raise ValueError("precision='dw' needs the Kronecker-sum operator "
                             "(the double-word apply exploits it)")
        if low_dtype == torch.bfloat16:
            raise NotImplementedError(
                "low_dtype=bfloat16 cycles are ROADMAP slice 2, item 16")
        if low_dtype != torch.float32:
            raise ValueError(f"low_dtype={low_dtype}: float32 only")
        self.precision = precision
        self.problem = problem
        self.levels = build_hierarchy(problem, num_levels, operator=operator)
        self.cfg = replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                       self.levels[0].A))
        self.lams = attach_spectral_estimates(self.levels, self.cfg.smoother)
        self.mixed = mixed and problem.space.dtype == torch.float64
        if precision == "dw" and not self.mixed:
            raise ValueError("precision='dw' requires mixed=True and an f64 "
                             f"problem (got mixed={mixed}, dtype="
                             f"{problem.space.dtype})")
        self.levels_pre = (_cast_levels(self.levels, low_dtype)
                           if self.mixed else self.levels)
        self.low_dtype = low_dtype
        if precision == "dw":
            A64 = self.levels[0].A
            self._labels = A64._band_labels()
            split = {id(B): split_f64(B) for term in A64.terms
                     for B in term}
            self._terms_df = tuple(tuple(split[id(B)] for B in term)
                                   for term in A64.terms)
            sp = problem.space
            self._plan_df = build_kron_df_plan(
                self._terms_df, sp.npts, sp.pads, sp.periodic, self._labels)

    # -- f64 recurrences ----------------------------------------------------
    def _precond(self, r: StencilVector) -> StencilVector:
        sp_pre = self.levels_pre[0].A.space
        safe = _safe(r.norm())
        r_lo = StencilVector.from_interior(
            sp_pre, (r.interior / safe).to(sp_pre.dtype))
        z_lo = cycle(self.levels_pre, 0, StencilVector.zeros(sp_pre), r_lo,
                     self.cfg, self.lams)
        return StencilVector.from_interior(
            r.space, z_lo.interior.to(r.space.dtype) * safe)

    def _step(self, x, r, z, p, rz):
        Ap = self.levels[0].A.dot(p)
        alpha = rz / p.dot(Ap)
        x = x.axpy(alpha, p)
        r_new = r.axpy(-alpha, Ap)
        z_new = self._precond(r_new)
        rz_new = r_new.dot(z_new)
        beta = (rz_new - r_new.dot(z)) / rz
        p = z_new.axpy(beta, p)
        return x, r_new, z_new, p, rz_new, r_new.norm()

    # -- double-word recurrences ----------------------------------------------
    def _apply_A_dw(self, ph):
        """A·p in double-word from an f32 direction p (the dw residual with
        b = 0 and a zero low word gives −A·p): one K5 launch on the card."""
        sp = self.problem.space
        nh, nl = residual_kron_df(self._terms_df, None, None, ph, None,
                                  sp.pads, labels=self._labels,
                                  periodic=sp.periodic, plan=self._plan_df)
        return -nh, -nl

    def _precond_dw(self, rh, rl, scale):
        """z ≈ M⁻¹r: one f32 cycle on the unit-scaled hi word, rescaled by
        ``scale`` = ‖r‖ (the step computes that norm for convergence)."""
        sp_pre = self.levels_pre[0].A.space
        safe = _safe(scale).to(torch.float32)
        r_hat = StencilVector.from_interior(sp_pre, rh / safe)
        z_hat = cycle(self.levels_pre, 0, StencilVector.zeros(sp_pre), r_hat,
                      self.cfg, self.lams)
        return z_hat.interior * safe

    def _step_dw(self, xh, xl, rh, rl, z, p, rz):
        zp = torch.zeros_like(p)
        aph, apl = self._apply_A_dw(p)
        alpha = rz / dw_dot(p, zp, aph, apl)
        a_h, a_l = split_f64(alpha)
        dxh, dxl = dw_mul(a_h, a_l, p, zp)
        xh, xl = dw_add(xh, xl, dxh, dxl)
        drh, drl = dw_mul(-a_h, -a_l, aph, apl)
        rh, rl = dw_add(rh, rl, drh, drl)
        rn = dw_norm2(rh, rl)
        z_new = self._precond_dw(rh, rl, rn)
        # ρ_new = z_newᵀr_new and the flexible β = z_newᵀ(r_new − r_old)/ρ
        # with r_new − r_old = −αAp: one batched tree for both dots
        zz = torch.zeros_like(z_new)
        rz_new, s = dw_dot_stack([(z_new, zz, rh, rl), (z_new, zz, drh, drl)])
        p = z_new + (s / rz).to(torch.float32) * p
        return xh, xl, rh, rl, z_new, p, rz_new, rn

    # -- solve loops ----------------------------------------------------------
    def _start(self, b: Optional[StencilVector], b_pair=None):
        """State at x = 0 (first preconditioned residual included), the
        step that advances it, and ‖r₀‖."""
        if self.precision == "dw":
            bh, bl = b_pair if b_pair is not None else split_f64(b.interior)
            rn = dw_norm2(bh, bl)
            z = self._precond_dw(bh, bl, rn)
            zero = torch.zeros_like(bh)
            state = (zero, zero, bh, bl, z, z, dw_dot(z, zero, bh, bl))
            return state, self._step_dw, rn
        z = self._precond(b)
        state = (StencilVector.zeros(self.problem.space), b, z, z, b.dot(z))
        return state, self._step, b.norm()

    def _x_interior(self, state) -> torch.Tensor:
        if self.precision == "dw":
            return merge_f64(state[0], state[1])
        return state[0].interior

    def solve(self, b: Optional[StencilVector] = None, tol: float = 1e-10,
              maxiter: int = 100) -> SolveResult:
        """Host loop; records ‖r‖ after every iteration (one sync each)."""
        b = b if b is not None else self.problem.b
        sp = self.problem.space
        residuals = [float(b.norm())]
        if residuals[-1] <= tol:
            return SolveResult(x=StencilVector.zeros(sp), residuals=residuals,
                               iterations=0, converged=True)
        state, step, _ = self._start(b)
        wall = []
        it, converged = 0, False
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            *state, rn = step(*state)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
        return SolveResult(x=StencilVector.from_interior(
                               sp, self._x_interior(state)),
                           residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 100,
                       b_pair=None, return_x: bool = True):
        """The same iterations as :meth:`solve` without the history.

        Returns ``(x, rn, it)``: ``rn`` a 0-dim f64 tensor, ``it`` an int.
        ``b_pair=(bh, bl)`` (dw only) supplies the split RHS so the caller
        can free the f64 ``b``; ``return_x=False`` returns the f64 interior
        instead of a StencilVector.
        """
        if b_pair is None:
            b = b if b is not None else self.problem.b
        elif self.precision != "dw":
            raise ValueError("b_pair is for precision='dw'")
        state, step, rn = self._start(b, b_pair)
        it = 0
        while float(rn) > tol and it < maxiter:
            *state, rn = step(*state)
            it += 1
        x_int = self._x_interior(state)
        if return_x:
            x_int = StencilVector.from_interior(self.problem.space, x_int)
        return x_int, rn, it
