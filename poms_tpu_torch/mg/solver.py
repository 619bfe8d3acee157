"""Solve results (counterpart of ``poms_tpu.mg.solver.SolveResult``).

``MultigridSolver`` is ROADMAP slice 2.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from poms_tpu_torch.core.vector import StencilVector

__all__ = ["SolveResult"]


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
