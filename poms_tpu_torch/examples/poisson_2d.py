"""2D Poisson, the full V-cycle hierarchy with Galerkin coarse operators.

Counterpart of the JAX package's ``examples/poisson_2d.py``: the banded
``MultigridSolver``, weighted Jacobi (ω = 0.8), V-, W- or FMG-cycles.

Run:  python -m poms_tpu_torch.examples.poisson_2d [n_el] [degree] [levels]
          [cycle: v|w|fmg] [--cpu]
"""
from __future__ import annotations

from poms_tpu_torch.examples import cli_device, int_args
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)

__all__ = ["build", "main"]


def build(n_el: int = 64, degree: int = 3, levels: int = 4,
          kind: str = "v", device=None):
    prob = poisson_problem(2, n_el, degree=degree, device=device)
    cfg = CycleConfig(gamma=2 if kind == "w" else 1,
                      smoother=SmootherConfig(kind="jacobi", omega=0.8))
    return prob, MultigridSolver(prob, num_levels=levels, cfg=cfg)


def main(n_el: int = 64, degree: int = 3, levels: int = 4, kind: str = "v",
         device=None, out=print) -> dict:
    prob, mg = build(n_el, degree, levels, kind, device)
    res = mg.solve(tol=1e-10, maxiter=100, use_fmg=(kind == "fmg"))
    for i, r in enumerate(res.residuals):
        out(f"cycle {i:3d}  ||r|| = {r:.6e}")
    l2 = l2_error_manufactured(prob, res.x)
    out(f"{kind}-cycle converged={res.converged} in {res.iterations}; "
        f"L2 err = {l2:.3e}")
    return {"residuals": list(res.residuals), "iterations": res.iterations,
            "converged": res.converged, "l2_error": l2}


if __name__ == "__main__":
    main(*int_args(n=4), device=cli_device())
