"""Multigrid solver driver: hierarchy setup, convergence loop, history.

Counterpart of ``poms_tpu.mg.solver``: :meth:`MultigridSolver.solve`
iterates cycles until ‖r‖₂ ≤ tol (absolute, or relative to ‖b‖ with
``rtol=True``) and records the residual history (and logs each cycle to a
``ConvergenceLogger``); ``solve_compiled`` runs the same cycles without the
history and returns ``(x, rn, it)``: on the card one captured CUDA graph
replayed per cycle (:mod:`poms_tpu_torch.mg.graph`), on the CPU the eager
loop.  Either way the host reads ‖r‖ once per cycle.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import List, Optional

from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig, cycle, fmg
from poms_tpu_torch.mg.graph import GraphedStep
from poms_tpu_torch.mg.hierarchy import Level, build_hierarchy
from poms_tpu_torch.mg.smoother import attach_spectral_estimates, resolve_omega
from poms_tpu_torch.models.periodic import build_periodic_hierarchy

__all__ = ["MultigridSolver", "SolveResult", "LamsOwner", "log_rho",
           "build_levels"]


def build_levels(problem, num_levels: int, operator: str) -> List[Level]:
    """The problem's hierarchy: a ``PeriodicProblem`` (it has a ``shift``)
    builds its own, as the JAX package's mixed-precision solvers do."""
    build = (build_periodic_hierarchy if hasattr(problem, "shift")
             else build_hierarchy)
    return build(problem, num_levels, operator=operator)


@dataclass
class SolveResult:
    x: StencilVector
    residuals: List[float]
    iterations: int
    converged: bool
    wall_times: List[float] = field(default_factory=list)

    @property
    def convergence_factors(self) -> List[float]:
        r = self.residuals
        return [r[i + 1] / r[i] for i in range(len(r) - 1) if r[i] > 0]


class LamsOwner:
    """``lams``, the per-level λmax(D⁻¹A) estimates (Chebyshev only): the
    cycles read it at every call, so it may be replaced after construction.
    A captured graph has the Chebyshev coefficients baked in, so replacing
    ``lams`` drops the solver's cached graphs (``_graphs``)."""

    @property
    def lams(self):
        return self._lams

    @lams.setter
    def lams(self, value):
        self._lams = value
        self._graphs = {}


def log_rho(logger, it: int, residuals: List[float], wall_s: float) -> None:
    """One ``log_cycle`` record for the newest entry of ``residuals``."""
    if logger is not None:
        prev = residuals[-2]
        logger.log_cycle(cycle=it, residual=residuals[-1],
                         rho=residuals[-1] / prev if prev else 0.0,
                         wall_s=wall_s)


class MultigridSolver(LamsOwner):
    """Geometric multigrid solver for tensor-product B-spline problems (a
    ``PoissonProblem`` or a ``PeriodicProblem``)."""

    def __init__(self, problem, num_levels: int,
                 cfg: CycleConfig = CycleConfig(), operator: str = "banded"):
        self.problem = problem
        self.levels: List[Level] = build_levels(problem, num_levels, operator)
        self.cfg = replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                       self.levels[0].A))
        self.lams = attach_spectral_estimates(self.levels, self.cfg.smoother)

    def _residual_norm(self, x: StencilVector, b: StencilVector):
        return (b - self.levels[0].A.dot(x)).norm()

    def _step(self, x: StencilVector, b: StencilVector):
        x = cycle(self.levels, 0, x, b, self.cfg, self.lams)
        return x, self._residual_norm(x, b)

    def solve(self, b: Optional[StencilVector] = None,
              x0: Optional[StencilVector] = None,
              tol: float = 1e-10, maxiter: int = 50,
              rtol: bool = False, use_fmg: bool = False,
              logger=None) -> SolveResult:
        """Iterate cycles to tolerance, recording ‖r‖₂ after each.

        ``use_fmg`` starts from a full-multigrid pass, else from ``x0`` (zero
        by default); ``logger`` (a ``ConvergenceLogger``) gets one record
        per cycle.
        """
        b = b if b is not None else self.problem.b
        space = self.levels[0].A.space
        if use_fmg:
            x = fmg(self.levels, b, self.cfg, lams=self.lams)
        elif x0 is None:
            x = StencilVector.zeros(space)
        else:
            x = x0
        residuals = [float(self._residual_norm(x, b))]
        wall = []
        target = tol * float(b.norm()) if rtol else tol
        converged = residuals[-1] <= target
        it = 0
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            x, rn = self._step(x, b)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= target
            log_rho(logger, it, residuals, wall[-1])
        return SolveResult(x=x, residuals=residuals, iterations=it,
                           converged=converged, wall_times=wall)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 50):
        """The cycles of :meth:`solve` from x = 0 without the history.

        Returns ``(x, rn, it)``: ``rn`` a 0-dim tensor on the field's
        device, ``it`` an int.
        """
        b = b if b is not None else self.problem.b
        space = self.levels[0].A.space
        x = StencilVector.zeros(space)
        rn = self._residual_norm(x, b)
        it = 0
        if space.device.type != "cuda":
            while float(rn) > tol and it < maxiter:
                x, rn = self._step(x, b)
                it += 1
            return x, rn, it

        def step(x_int, b_int):
            x, rn = self._step(StencilVector.from_interior(space, x_int),
                               StencilVector.from_interior(space, b_int))
            return x.interior, rn

        if "mg" not in self._graphs:
            self._graphs["mg"] = GraphedStep(step, [x.interior],
                                             [b.interior])
        graph = self._graphs["mg"]
        graph.load([x.interior], [b.interior])
        while float(rn) > tol and it < maxiter:
            rn = graph.replay()
            it += 1
        return (StencilVector.from_interior(space, graph.state[0].clone()),
                rn.clone(), it)
