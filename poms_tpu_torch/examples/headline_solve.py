"""The headline solve: 3D Poisson to ‖r‖₂ ≤ 1e-10 on the fast path.

Counterpart of the JAX package's ``examples/headline_solve.py``:

- the Kronecker-sum operator (K1 for the f32 cycles, K5 for the
  double-word residual or A·p);
- Chebyshev(4)-smoothed f32 V-cycles, ν1 = ν2 = 1, over [λmax/16, λmax]
  for PCG and [λmax/32, λmax] for defect correction;
- double-word f32 outer recurrences (K6r, K6u);
- ``solve_compiled``: on the card one captured CUDA graph replayed per
  iteration.

Run:  python -m poms_tpu_torch.examples.headline_solve [n_el] [degree]
          [solver] [--cpu]
      solver ∈ {dc, pcg}   (defect correction | dw-precision MG-PCG)
      degree 1-3 on the compiled K1 and K5; from 4 on K1r and K5r, which
      take the half-width at run time, up to half-width 138
      (``ops/kron.py::widest_half_width``; wider bands are refused on the
      card)

``main`` also returns the cold setup (problem, hierarchy, λ estimates and
K1's launch data: ``setup_s``; the first ``solve_compiled``, which warms the
step up and captures its graph: ``cold_solve_s``) and, on the card, the
peak of ``torch.cuda.max_memory_allocated`` over the run.
"""
from __future__ import annotations

import time

import torch

from poms_tpu_torch.examples import cli_device, int_args
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)

__all__ = ["build", "main", "num_levels"]


def num_levels(n_el: int) -> int:
    return max(2, (n_el - 1).bit_length() - 2)


def build(n_el: int = 64, degree: int = 3, solver: str = "dc",
          device=None):
    """(problem, solver) of the headline configuration."""
    if solver not in ("dc", "pcg"):
        raise ValueError(f"solver={solver!r}: 'dc' or 'pcg'")
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=torch.float64, device=device)
    # window fractions: PCG is insensitive (16 kept); defect correction
    # prefers 32 at 128³ and above (the JAX package's sweep)
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0 if solver == "pcg" else 32.0))
    if solver == "pcg":
        mg = MGPreconditionedCG(prob, num_levels=num_levels(n_el), cfg=cfg,
                                mixed=True, operator="kron", precision="dw")
    else:
        mg = MixedPrecisionMG(prob, num_levels=num_levels(n_el), cfg=cfg,
                              operator="kron", residual="twofloat")
    return prob, mg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(n_el: int = 64, degree: int = 3, solver: str = "dc", device=None,
         lams=None, out=print, check=None, maxiter: int = 100) -> dict:
    """Solve, print the JAX example's lines through ``out`` and return the
    numbers.  ``lams``: λ estimates to use instead of the solver's own (set
    before the first solve); ``check(problem, solver, x)``, called last,
    gives ``out["check"]``; ``maxiter``: iterations a solve may take."""
    levels = num_levels(n_el)
    out(f"3D Poisson n_el={n_el}^3 degree={degree} levels={levels} "
        f"solver={solver}")
    t0 = time.perf_counter()
    prob, mg = build(n_el, degree, solver, device)
    dev = prob.space.device
    if lams is not None:
        mg.lams = tuple(lams)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=maxiter)  # build, warm
    _sync(dev)
    cold_solve_s = time.perf_counter() - t0
    del x
    t0 = time.perf_counter()
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=maxiter)
    _sync(dev)
    wall = time.perf_counter() - t0
    true = float(torch.linalg.vector_norm(prob.A.residual(x, prob.b)))
    out(f"converged in {int(it)} iterations, wall {wall:.4f} s "
        f"({wall / max(int(it), 1) * 1e3:.2f} ms/iter)")
    out(f"‖r‖₂ = {float(rn):.3e} (true: {true:.3e})")
    l2 = l2_error_manufactured(prob, x)
    out(f"L2 error vs manufactured solution: {l2:.3e}")
    res = {"n_el": n_el, "degree": degree, "levels": levels,
           "solver": solver, "iterations": int(it),
           "converged": float(rn) <= 1e-10, "wall_s": wall,
           "ms_per_iter": wall / max(int(it), 1) * 1e3, "rn": float(rn),
           "true_residual": true, "l2_error": l2, "setup_s": setup_s,
           "cold_solve_s": cold_solve_s}
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if check is not None:
        res["check"] = check(prob, mg, x)
    return res


if __name__ == "__main__":
    args = int_args(n=3)
    main(args[0] if args else 64, args[1] if len(args) > 1 else 3,
         args[2] if len(args) > 2 else "dc", device=cli_device())
