"""3D Poisson: red-black Gauss–Seidel cycles, then MG-preconditioned CG.

Counterpart of the JAX package's ``examples/poisson_3d.py``: assemble, run
banded RB-GS V(2,2)-cycles (``MultigridSolver``, K2 or K3 on the card) to
‖r‖ ≤ 1e-6 or 60 cycles, which stall at ρ ≈ 0.95 (small-eigenvalue
oscillatory modes of cubic B-splines stall plain cycles of any pointwise
smoother), then the production answer: the double-word MG-preconditioned CG
with Chebyshev(4) cycles on the Kronecker-sum operator, to ‖r‖ ≤ 1e-10.

Run:  python -m poms_tpu_torch.examples.poisson_3d [n_el] [degree] [levels]
          [--cpu]
"""
from __future__ import annotations

import numpy as np

from poms_tpu_torch.examples import cli_device, int_args
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver, SolveResult
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)
from poms_tpu_torch.utils.logging import ConvergenceLogger

__all__ = ["build", "main"]


def build(n_el: int = 16, degree: int = 3, levels: int = 3, device=None):
    """(problem, RB-GS ``MultigridSolver``, dw ``MGPreconditionedCG``)."""
    prob = poisson_problem(3, n_el, degree=degree, device=device)
    cfg = CycleConfig(nu1=2, nu2=2,
                      smoother=SmootherConfig(kind="rbgs", omega=1.0))
    mg = MultigridSolver(prob, num_levels=levels, cfg=cfg)
    cfgc = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfgc, mixed=True,
                             operator="kron", precision="dw")
    return prob, mg, pcg


def main(n_el: int = 16, degree: int = 3, levels: int = 3, device=None,
         pcg_lams=None, log_stream=None, out=print) -> dict:
    """``pcg_lams``: λ estimates for the PCG's cycle instead of its own;
    ``log_stream``: where the RB-GS leg's JSON records go (stdout)."""
    out(f"3D Poisson: n_el={n_el}^3, degree={degree}, {levels} levels, "
        f"RB-GS smoother")
    prob, mg, pcg = build(n_el, degree, levels, device)
    with ConvergenceLogger(stream=log_stream, meta={
            "config": 3, "n_el": n_el, "degree": degree}) as log:
        res = mg.solve(tol=1e-6, maxiter=60, logger=log)
    rbgs = {"residuals": list(res.residuals), "iterations": res.iterations,
            "rho_median": float(np.median(res.convergence_factors))}
    out(f"plain RB-GS V-cycles: |r| {res.residuals[-1]:.3e} after "
        f"{res.iterations} cycles (rho ~ {rbgs['rho_median']:.2f} — the "
        f"documented high-degree B-spline pathology: small-eigenvalue "
        f"oscillatory modes stall plain cycles of ANY pointwise smoother "
        f"at p >= 3)")
    if pcg_lams is not None:
        pcg.lams = tuple(pcg_lams)
    x, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=60)
    out(f"MG-preconditioned CG (production config): converged="
        f"{float(rn) <= 1e-10} in {int(it)} iterations; "
        f"final residual {float(rn):.3e}")
    res = SolveResult(x=x, residuals=res.residuals + [float(rn)],
                      iterations=int(it), converged=float(rn) <= 1e-10,
                      wall_times=res.wall_times)
    err = l2_error_manufactured(prob, res.x, pts_per_dim=32)
    out(f"L2 error vs u = sin(πx)sin(πy)sin(πz): {err:.3e}")
    rho = res.convergence_factors
    med = float(np.median(rho)) if rho else None
    if rho:
        out(f"median convergence factor: {med:.3f}")
    return {"rbgs": rbgs, "pcg_iterations": int(it), "pcg_rn": float(rn),
            "converged": res.converged, "l2_error": err,
            "median_rho": med}


if __name__ == "__main__":
    main(*int_args(n=3), device=cli_device())
