"""Mixed-precision solvers: defect correction and MG-preconditioned CG.

Counterpart of ``poms_tpu.mg.mixed``.  The tolerance target ‖r‖ ≤ 1e-10 is
f64 territory while the fast cycles are f32; both solvers keep the f32 cycle
on a residual scaled to O(1) and carry the iterate in higher precision.
``low_dtype=torch.bfloat16`` runs the cycle on a bf16 hierarchy instead
(bf16 instantiations of K1, K2/K3 and K7, an f32 coarse factor); the outer
recurrences stay what they are: f64, or f32 pairs.  Both solvers take a
``PoissonProblem`` or a ``PeriodicProblem``.

:class:`MixedPrecisionMG`, defect correction x ← x + E(b − A x) with E one
(or ``inner_cycles``) f32 cycle(s):

- ``residual="f64"``: the residual through the f64 operator (K1's f64
  instantiation on Kronecker-sum levels, K2/K3 on banded ones);
- ``residual="twofloat"``: x, b and r are double-word f32 pairs, the
  residual is K5, the update and the norm K6 (needs ``operator="kron"``).

:class:`MGPreconditionedCG`, flexible CG (IPCG / Polak–Ribière β, which
tolerates the slightly nonsymmetric f32 preconditioner) with one multigrid
cycle as the preconditioner:

- ``precision="dw"``: x and r are double-word f32 pairs, A·p is the
  double-word Kronecker apply (K5), directions and the V-cycle are f32, and
  α, β, ρ are f64 scalars on the device.  Needs ``mixed=True`` and
  ``operator="kron"``.
- ``precision="dwrr"``: the working residual in plain f32 and A·p through
  the low-precision operator (K1; on a bf16 hierarchy the direction is
  rounded to bf16 for that pass), x a double-word pair; every ``replace_every`` iterations the true residual is
  recomputed from x in double-word (K5) and the search restarts from it, and
  only that residual is tested against the tolerance.  The reference
  measured it slower than ``dw``; it is opt-in.
- ``precision="f64"``: the recurrences in f64, the cycle in f32 when
  ``mixed`` (else in f64); banded (K2) or Kronecker-sum (K1) levels.

``solve`` is the host loop with its residual history and logger;
``solve_compiled`` runs the same iterations without the history and returns
``(x, rn, it)``.  On the card ``solve_compiled`` replays one captured CUDA
graph per iteration (:mod:`poms_tpu_torch.mg.graph`; per round of
``replace_every`` iterations for ``dwrr``), cached on the solver; the host
reads one scalar (‖r‖) per replay.  On the CPU it is the eager loop.
"""
from __future__ import annotations

import functools
import time
from dataclasses import replace
from typing import Optional

import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig, cycle
from poms_tpu_torch.mg.graph import GraphedStep
from poms_tpu_torch.mg.hierarchy import Level
from poms_tpu_torch.mg.smoother import attach_spectral_estimates, resolve_omega
from poms_tpu_torch.mg.solver import (LamsOwner, SolveResult, build_levels,
                                      log_rho)
from poms_tpu_torch.models.poisson import PoissonProblem
from poms_tpu_torch.ops.cholesky import DenseCholesky
from poms_tpu_torch.ops.twofloat import (build_kron_df_plan, dw_dot,
                                         dw_dot_stack, dw_norm2, dw_update,
                                         merge_f64, residual_kron_df,
                                         split_f64)
from poms_tpu_torch.utils.trace import span

__all__ = ["MGPreconditionedCG", "MixedPrecisionMG"]

def _cast_levels(levels, dtype: torch.dtype):
    """Cast a hierarchy's bands, transfer weights and Cholesky factor.

    Each distinct tensor is cast once (keyed by identity), so the terms of
    a cast Kronecker-sum operator share band objects as the originals did.
    A bf16 hierarchy keeps its coarse factor in f32 (``ops/cholesky.py``)."""
    factor_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    cast = {}

    def c(t):
        if id(t) not in cast:
            cast[id(t)] = t.to(dtype)
        return cast[id(t)]

    def tbands(tbs):
        return None if tbs is None else tuple(
            replace(tb, w=c(tb.w)) for tb in tbs)

    out = []
    for lev in levels:
        sp = lev.A.space.with_dtype(dtype)
        if isinstance(lev.A, StencilMatrix):   # packed for K3 under v2
            A = StencilMatrix(sp, band_t=c(lev.A.band_t)).ensure_packed_v2()
        else:
            A = KroneckerSumOperator(
                sp, [[c(B) for B in term] for term in lev.A.terms])
        chol = None if lev.chol is None else DenseCholesky(
            L=lev.chol.L.to(factor_dtype))
        out.append(Level(A=A, restrict=tbands(lev.restrict),
                         prolong=tbands(lev.prolong), chol=chol))
    return out


def _safe(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _norm(t: torch.Tensor) -> torch.Tensor:
    """‖t‖₂ as StencilVector.norm forms it."""
    flat = t.reshape(-1)
    return torch.sqrt(torch.vdot(flat, flat))


def _check_low_dtype(low_dtype):
    if low_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"low_dtype={low_dtype}: float32 or bfloat16")


class _DoubleWordOperator:
    """The finest operator split into (hi, lo) f32 bands, each distinct band
    once so the sharing labels stay valid, with K5's launch data."""

    def _split_operator(self, A64, space):
        self._labels = A64._band_labels()
        split = {id(B): split_f64(B) for term in A64.terms for B in term}
        self._terms_df = tuple(tuple(split[id(B)] for B in term)
                               for term in A64.terms)
        self._plan_df = build_kron_df_plan(
            self._terms_df, space.npts, space.pads, space.periodic,
            self._labels)

    def _residual_dw(self, bh, bl, xh, xl, negate=False):
        """b − A·x in double-word (``negate``: A·x − b): one K5 launch."""
        sp = self.problem.space
        return residual_kron_df(self._terms_df, bh, bl, xh, xl, sp.pads,
                                labels=self._labels, periodic=sp.periodic,
                                plan=self._plan_df, negate=negate)


def _graph_loop(solver, key, step, state, consts, rn, tol, maxiter,
                per_replay=1):
    """Replay ``step``'s graph (captured once per solver and ``key``) from
    ``state`` until ‖r‖ ≤ tol; returns the static state, ‖r‖ and the
    iteration count."""
    if key not in solver._graphs:
        solver._graphs[key] = GraphedStep(step, state, consts)
    graph = solver._graphs[key]
    # after the capture too: its warm-up step may have written its state
    # buffers in place
    graph.load(state, consts)
    it = 0
    while float(rn) > tol and it < maxiter:
        rn = graph.replay()
        it += per_replay
    return graph.state, rn.clone(), it


class MixedPrecisionMG(LamsOwner, _DoubleWordOperator):
    """Defect-correction multigrid: high-precision residuals, f32 cycles.

    ``residual`` selects how the outer residual r = b − A·x is computed:
    ``"f64"`` (the f64 operator), ``"twofloat"`` (double-word f32 pairs for
    the iterate, the right-hand side and the residual; needs
    ``operator="kron"``) or ``"auto"`` (twofloat on a Kronecker-sum
    operator, else f64).  ``inner_cycles`` f32 cycles per outer correction
    are chained through the f32 residual of the error equation.
    """

    def __init__(self, problem: PoissonProblem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(),
                 low_dtype: torch.dtype = torch.float32,
                 operator: str = "banded", residual: str = "auto",
                 inner_cycles: int = 1):
        if problem.space.dtype != torch.float64:
            raise ValueError("build the problem in f64; the low-precision "
                             "hierarchy is derived from it")
        if residual == "auto":
            residual = "twofloat" if operator == "kron" else "f64"
        if residual not in ("f64", "twofloat"):
            raise ValueError(f"residual={residual!r}")
        if residual == "twofloat" and operator != "kron":
            raise ValueError("residual='twofloat' needs the Kronecker-sum "
                             "operator (structure the dw residual exploits)")
        _check_low_dtype(low_dtype)
        self.residual_mode = residual
        self.inner_cycles = max(1, int(inner_cycles))
        self.problem = problem
        self.levels64 = build_levels(problem, num_levels, operator)
        with span("poms.setup.lambda", sync=True):
            self.cfg = replace(cfg, smoother=resolve_omega(
                cfg.smoother, self.levels64[0].A))
            self.lams = attach_spectral_estimates(self.levels64,
                                                  self.cfg.smoother)
        self.levels32 = _cast_levels(self.levels64, low_dtype)
        self.low_dtype = low_dtype
        if residual == "twofloat":
            self._split_operator(self.levels64[0].A, problem.space)

    def _error_cycles(self, r32: StencilVector) -> StencilVector:
        """``inner_cycles`` low-precision cycles on the error equation, chained
        through its low-precision residual (one operator pass per extra
        cycle; the outer residual and norm are not recomputed between)."""
        sp32 = self.levels32[0].A.space
        e32 = cycle(self.levels32, 0, StencilVector.zeros(sp32), r32,
                    self.cfg, self.lams)
        for _ in range(self.inner_cycles - 1):
            d = StencilVector.from_interior(
                sp32, self.levels32[0].A.residual(e32, r32))
            de = cycle(self.levels32, 0, StencilVector.zeros(sp32), d,
                       self.cfg, self.lams)
            e32 = StencilVector.from_interior(
                sp32, e32.interior + de.interior)
        return e32

    def _step(self, x_int, b_int):
        """One correction with f64 residuals → (x interior, ‖b − A x‖)."""
        A, sp = self.levels64[0].A, self.problem.space
        sp32 = self.levels32[0].A.space
        b = StencilVector.from_interior(sp, b_int)
        r = A.residual(StencilVector.from_interior(sp, x_int), b)
        safe = _safe(_norm(r))
        e32 = self._error_cycles(StencilVector.from_interior(
            sp32, (r / safe).to(self.low_dtype)))
        x_int = x_int + e32.interior.to(torch.float64) * safe
        r = A.residual(StencilVector.from_interior(sp, x_int), b)
        return x_int, _norm(r)

    def _step_tf(self, xh, xl, rh, rl, rn_prev, bh, bl):
        """One correction from the current double-word residual, then the
        new residual.  ``rn_prev`` is ‖(rh, rl)‖ from the previous step (or
        ‖b‖ at the start): the scale of the cycle's right-hand side."""
        sp32 = self.levels32[0].A.space
        e32 = self._error_cycles(StencilVector.from_interior(
            sp32, dw_update("div", rh, rn_prev)))
        # the pair bookkeeping stays f32, whatever the cycle's dtype
        xh, xl = dw_update("defect", xh, xl, e32.interior.to(torch.float32),
                           rn_prev)
        rh, rl = self._residual_dw(bh, bl, xh, xl)
        rn = dw_norm2(rh, rl)
        return xh, xl, rh, rl, rn, rn

    def _start(self, b: Optional[StencilVector], b_pair=None):
        """(state, consts, step, ‖r₀‖) at x = 0."""
        with span("poms.solve.start"):
            if self.residual_mode == "twofloat":
                bh, bl = b_pair if b_pair is not None \
                    else split_f64(b.interior)
                rn = dw_norm2(bh, bl)
                zero = torch.zeros_like(bh)
                return ((zero, zero, bh, bl, rn), (bh, bl), self._step_tf,
                        rn)
            b_int = b.interior
            return ((torch.zeros_like(b_int),), (b_int,), self._step,
                    _norm(b_int))

    def _x_interior(self, state) -> torch.Tensor:
        if self.residual_mode == "twofloat":
            return merge_f64(state[0], state[1])
        return state[0]

    def solve(self, b: Optional[StencilVector] = None, tol: float = 1e-10,
              maxiter: int = 100, logger=None) -> SolveResult:
        """Host loop; records ‖r‖ after every correction (one sync each)."""
        with span("poms.solve"):
            b = b if b is not None else self.problem.b
            state, consts, step, _ = self._start(b)
            residuals = [float(b.norm())]
            wall = []
            it, converged = 0, residuals[-1] <= tol
            while not converged and it < maxiter:
                t0 = time.perf_counter()
                *state, rn = step(*state, *consts)
                rn = float(rn)
                wall.append(time.perf_counter() - t0)
                residuals.append(rn)
                it += 1
                converged = rn <= tol
                log_rho(logger, it, residuals, wall[-1])
            return SolveResult(
                x=StencilVector.from_interior(self.problem.space,
                                              self._x_interior(state)),
                residuals=residuals, iterations=it, converged=converged,
                wall_times=wall)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 100,
                       b_pair=None, return_x: bool = True):
        """The corrections of :meth:`solve` without the history: on the card
        one captured graph replayed per correction.

        Returns ``(x, rn, it)``: ``rn`` a 0-dim f64 tensor, ``it`` an int.
        ``b_pair=(bh, bl)`` (twofloat only) supplies the split right-hand
        side so the caller can free the f64 ``b``; ``return_x=False``
        returns the f64 interior instead of a StencilVector.
        """
        with span("poms.solve"):
            if b_pair is None:
                b = b if b is not None else self.problem.b
            elif self.residual_mode != "twofloat":
                raise ValueError("b_pair is for residual='twofloat'")
            state, consts, step, rn = self._start(b, b_pair)
            if state[0].device.type == "cuda":
                state, rn, it = _graph_loop(self, self.residual_mode, step,
                                            state, consts, rn, tol, maxiter)
            else:
                it = 0
                while float(rn) > tol and it < maxiter:
                    *state, rn = step(*state, *consts)
                    it += 1
            x_int = self._x_interior(state)
            if state[0].device.type == "cuda" \
                    and self.residual_mode != "twofloat":
                x_int = x_int.clone()   # the graph's buffer stays the solver's
            if return_x:
                x_int = StencilVector.from_interior(self.problem.space, x_int)
            return x_int, rn, it


class MGPreconditionedCG(LamsOwner, _DoubleWordOperator):
    """Flexible CG (IPCG) with one multigrid cycle as preconditioner."""

    def __init__(self, problem: PoissonProblem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(), mixed: bool = True,
                 low_dtype: torch.dtype = torch.float32,
                 operator: str = "banded", precision: str = "f64"):
        if precision not in ("f64", "dw", "dwrr"):
            raise ValueError(f"precision={precision!r}")
        if precision in ("dw", "dwrr") and operator != "kron":
            raise ValueError(f"precision={precision!r} needs the "
                             "Kronecker-sum operator (the double-word apply "
                             "exploits it)")
        _check_low_dtype(low_dtype)
        self.precision = precision
        self.replace_every = 3
        self.problem = problem
        self.levels = build_levels(problem, num_levels, operator)
        with span("poms.setup.lambda", sync=True):
            self.cfg = replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                           self.levels[0].A))
            self.lams = attach_spectral_estimates(self.levels,
                                                  self.cfg.smoother)
        self.mixed = mixed and problem.space.dtype == torch.float64
        if precision in ("dw", "dwrr") and not self.mixed:
            raise ValueError(f"precision={precision!r} requires mixed=True "
                             f"and an f64 problem (got mixed={mixed}, dtype="
                             f"{problem.space.dtype})")
        self.levels_pre = (_cast_levels(self.levels, low_dtype)
                           if self.mixed else self.levels)
        self.low_dtype = low_dtype
        if precision in ("dw", "dwrr"):
            self._split_operator(self.levels[0].A, problem.space)

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

    def _step_interiors(self, x, r, z, p, rz):
        """:meth:`_step` on interior tensors (the graph's state)."""
        sp = self.problem.space
        *new, rz, rn = self._step(
            *(StencilVector.from_interior(sp, t) for t in (x, r, z, p)), rz)
        return (*(v.interior for v in new), rz, rn)

    # -- double-word recurrences ----------------------------------------------
    def _apply_A_dw(self, ph):
        """A·p in double-word from an f32 direction p: the double-word
        residual with b = 0 and a zero low word, negated in the kernel
        (one K5 launch on the card)."""
        return self._residual_dw(None, None, ph, None, negate=True)

    def _precond_dw(self, rh, rl, scale, out=None):
        """z ≈ M⁻¹r: one f32 cycle on the unit-scaled hi word, rescaled by
        ``scale`` = ‖r‖ (the step computes that norm for convergence),
        written into ``out`` when given."""
        sp_pre = self.levels_pre[0].A.space
        r_hat = StencilVector.from_interior(sp_pre,
                                            dw_update("div", rh, scale))
        z_hat = cycle(self.levels_pre, 0, StencilVector.zeros(sp_pre), r_hat,
                      self.cfg, self.lams)
        return dw_update("mul", z_hat.interior.to(torch.float32), scale,
                         out=None if out is None else (out,))

    def _step_dw(self, xh, xl, rh, rl, z, p, rz, inplace=False):
        """One dw-PCG iteration.  ``inplace``: x, r, z and p are written
        into the buffers given and returned as themselves, for a captured
        graph's own state buffers only (the eager state holds the caller's
        b and one z twice)."""
        aph, apl = self._apply_A_dw(p)
        # α = ρ/pᵀAp; x += αp, r −= αAp, the scalars never leave the card
        out = (xh, xl, rh, rl, torch.empty_like(rh),
               torch.empty_like(rl)) if inplace else None
        xh, xl, rh, rl, drh, drl = dw_update(
            "cg", xh, xl, rh, rl, p, aph, apl, rz, dw_dot(p, None, aph, apl),
            out=out)
        rn = dw_norm2(rh, rl)
        # the old z is never read: the state carries it for its layout
        z_new = self._precond_dw(rh, rl, rn, out=z if inplace else None)
        # ρ_new = z_newᵀr_new and the flexible β = z_newᵀ(r_new − r_old)/ρ
        # with r_new − r_old = −αAp: one pass for both dots
        rz_new, s = dw_dot_stack([(z_new, None, rh, rl),
                                  (z_new, None, drh, drl)])
        p = dw_update("direction", z_new, p, s, rz,
                      out=(p,) if inplace else None)
        return xh, xl, rh, rl, z_new, p, rz_new, rn

    def _apply_low(self, p):
        """A·p through the low-precision operator (K1's apply mode) for the
        f32 direction p: on a bf16 hierarchy p is rounded to bf16 for the
        pass and the product cast back up."""
        A = self.levels_pre[0].A
        return A._apply_interior(p.to(A.space.dtype)).to(torch.float32)

    def _step_dwrr(self, xh, xl, rf, z, p, rz):
        """One residual-replacement iteration: f32 working residual ``rf``
        and low-precision A·p (K1), x a double-word pair."""
        ap = self._apply_low(p)
        xh, xl, dr, rf = dw_update("dwrr", xh, xl, p, ap, rf, rz,
                                   dw_dot(p, None, ap, None))
        z_new = self._precond_dw(rf, None, dw_norm2(rf, None))
        rz_new, s = dw_dot_stack([(z_new, None, rf, None),
                                  (z_new, None, dr, None)])
        p = dw_update("direction", z_new, p, s, rz)
        return xh, xl, rf, z_new, p, rz_new

    def _round_dwrr(self, xh, xl, rf, z, p, rz, bh, bl):
        """``replace_every`` iterations: all but the last on the f32 working
        residual; the last updates x only, then the true residual recomputed
        in double-word feeds the preconditioner, the stopping test and the
        restart p = z (stale directions across the replacement break
        conjugacy)."""
        for _ in range(self.replace_every - 1):
            xh, xl, rf, z, p, rz = self._step_dwrr(xh, xl, rf, z, p, rz)
        ap = self._apply_low(p)
        xh, xl = dw_update("dwrr", xh, xl, p, None, None, rz,
                           dw_dot(p, None, ap, None))
        rh, rl = self._residual_dw(bh, bl, xh, xl)
        rn = dw_norm2(rh, rl)
        z = self._precond_dw(rh, rl, rn)
        return xh, xl, rh, z, z, dw_dot(z, None, rh, rl), rn

    # -- solve loops ----------------------------------------------------------
    def _start(self, b: Optional[StencilVector], b_pair=None):
        """(state, consts, step, ‖r₀‖, iterations per step) at x = 0, the
        first preconditioned residual included."""
        with span("poms.solve.start"):
            if self.precision in ("dw", "dwrr"):
                bh, bl = b_pair if b_pair is not None \
                    else split_f64(b.interior)
                rn = dw_norm2(bh, bl)
                z = self._precond_dw(bh, bl, rn)
                zero = torch.zeros_like(bh)
                rz = dw_dot(z, None, bh, bl)
                if self.precision == "dw":
                    return ((zero, zero, bh, bl, z, z, rz), (), self._step_dw,
                            rn, 1)
                return ((zero, zero, bh, z, z, rz), (bh, bl), self._round_dwrr,
                        rn, self.replace_every)
            z = self._precond(b)
            state = (torch.zeros_like(b.interior), b.interior, z.interior,
                     z.interior, b.dot(z))
            return state, (), self._step_interiors, b.norm(), 1

    def _x_interior(self, state) -> torch.Tensor:
        if self.precision in ("dw", "dwrr"):
            return merge_f64(state[0], state[1])
        return state[0]

    def solve(self, b: Optional[StencilVector] = None, tol: float = 1e-10,
              maxiter: int = 100, logger=None) -> SolveResult:
        """Host loop; records ‖r‖ after every iteration (one sync each).
        ``dwrr`` has no per-iteration history: its result is one
        :meth:`solve_compiled` run with the two-entry history [‖b‖, ‖r‖]."""
        with span("poms.solve"):
            b = b if b is not None else self.problem.b
            sp = self.problem.space
            residuals = [float(b.norm())]
            if self.precision == "dwrr":
                x, rn, it = self.solve_compiled(b, tol=tol, maxiter=maxiter)
                return SolveResult(x=x, residuals=residuals + [float(rn)],
                                   iterations=it, converged=float(rn) <= tol)
            if residuals[-1] <= tol:
                return SolveResult(x=StencilVector.zeros(sp),
                                   residuals=residuals, iterations=0,
                                   converged=True)
            state, _, step, _, _ = self._start(b)
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
                log_rho(logger, it, residuals, wall[-1])
            return SolveResult(x=StencilVector.from_interior(
                                   sp, self._x_interior(state)),
                               residuals=residuals, iterations=it,
                               converged=converged, wall_times=wall)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 100,
                       b_pair=None, return_x: bool = True):
        """The same iterations as :meth:`solve` without the history: on the
        card one captured graph replayed per iteration (per round of
        ``replace_every`` for ``dwrr``, whose count is a multiple of it).

        Returns ``(x, rn, it)``: ``rn`` a 0-dim f64 tensor, ``it`` an int.
        ``b_pair=(bh, bl)`` (dw, dwrr) supplies the split RHS so the caller
        can free the f64 ``b``; ``return_x=False`` returns the f64 interior
        instead of a StencilVector.
        """
        with span("poms.solve"):
            if b_pair is None:
                b = b if b is not None else self.problem.b
            elif self.precision == "f64":
                raise ValueError("b_pair is for precision='dw' and 'dwrr'")
            state, consts, step, rn, per_step = self._start(b, b_pair)
            if state[0].device.type == "cuda":
                if self.precision == "dw":
                    # the graph's step writes into the graph's own buffers
                    step = functools.partial(step, inplace=True)
                state, rn, it = _graph_loop(self, self.precision, step, state,
                                            consts, rn, tol, maxiter, per_step)
            else:
                it = 0
                while float(rn) > tol and it < maxiter:
                    *state, rn = step(*state, *consts)
                    it += per_step
            x_int = self._x_interior(state)
            if state[0].device.type == "cuda" and self.precision == "f64":
                x_int = x_int.clone()   # the graph's buffer stays the solver's
            if return_x:
                x_int = StencilVector.from_interior(self.problem.space, x_int)
            return x_int, rn, it
