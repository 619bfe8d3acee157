"""1D Poisson, cubic B-splines, two grids, weighted Jacobi.

Counterpart of the JAX package's ``examples/poisson_1d.py`` (the smallest
configuration): the banded ``MultigridSolver`` (K2, or K3 under
``POMS_TPU_SPMV=v2``, on the card).

Run:  python -m poms_tpu_torch.examples.poisson_1d [n_el] [--cpu]
"""
from __future__ import annotations

from poms_tpu_torch.examples import cli_device, int_args
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)

__all__ = ["build", "main"]


def build(n_el: int = 64, device=None):
    prob = poisson_problem(1, n_el, degree=3, device=device)
    cfg = CycleConfig(smoother=SmootherConfig(kind="jacobi", omega=2 / 3))
    return prob, MultigridSolver(prob, num_levels=2, cfg=cfg)


def main(n_el: int = 64, device=None, out=print) -> dict:
    prob, mg = build(n_el, device)
    res = mg.solve(tol=1e-10, maxiter=60)
    for i, r in enumerate(res.residuals):
        out(f"cycle {i:3d}  ||r|| = {r:.6e}")
    l2 = l2_error_manufactured(prob, res.x, pts_per_dim=512)
    out(f"converged={res.converged}; L2 error = {l2:.3e}")
    return {"residuals": list(res.residuals), "iterations": res.iterations,
            "converged": res.converged, "l2_error": l2}


if __name__ == "__main__":
    main(*int_args(n=1), device=cli_device())
