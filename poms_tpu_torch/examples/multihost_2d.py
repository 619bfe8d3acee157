"""A multi-process distributed 2D solve, stepped cycle by cycle.

Counterpart of the JAX package's ``examples/multihost_2d.py``: every rank
is one process (started here by :mod:`poms_tpu_torch.parallel.launch`; on
several hosts each runs ``parallel.bootstrap.initialize`` with the shared
address), holds only its block, and reads the replicated residual norm
after each ``DistributedMG.step``.  2D Poisson, p = 2, two levels,
Chebyshev(4) over [λmax/16, λmax], ν1 = ν2 = 1, 16 elements a rank along
each mesh axis.  In f64 by default on every device; ``dtype=torch.float32``
(``--f32``) is the JAX example's precision on an accelerator, where its
|r| stalls near 1.3e-6 from the fourth cycle on, above the example's
1e-6·‖b‖ test (‖b‖ = 0.434): the JAX example stalls there too, in the same
cycle (``tests/test_torch_examples_dist.py``), and the card computes f64
natively.

Run:  python -m poms_tpu_torch.examples.multihost_2d
          (--backend gloo|nccl | --cpu) [--ranks N] [--f32]
"""
from __future__ import annotations

import sys

import torch

from poms_tpu_torch.examples import dist_cli, launches, rank_device
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem

__all__ = ["build", "main", "rank_steps", "mesh_of"]

CYCLES = 10


def mesh_of(ranks: int):
    return (max(1, ranks // 2), min(2, ranks))


def build(mesh, device, dtype=torch.float64):
    """(problem, DistributedMG) on this rank (inside a process group)."""
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = poisson_problem(2, (16 * mesh[0], 16 * mesh[1]), degree=2,
                           dtype=dtype, device=device)
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    return prob, DistributedMG(prob, num_levels=2, mesh_shape=mesh, cfg=cfg)


def rank_steps(spec: dict) -> dict:
    """What every rank runs: ``CYCLES`` steps from x = 0."""
    prob, mg = build(spec["mesh"], rank_device(spec["device"]),
                     spec["dtype"])
    if spec.get("lams") is not None:
        mg.lams = tuple(spec["lams"])
    b_loc = mg.local(prob.b.interior)
    x = torch.zeros_like(b_loc)
    rns = []
    for _ in range(CYCLES):
        x, rn = mg.step(x, b_loc)
        rns.append(float(rn))          # replicated: the same on every rank
    b_norm = float(torch.linalg.vector_norm(prob.b.interior))
    return {"residuals": rns, "ok": rns[-1] < 1e-6 * b_norm,
            "launches": launches()}


def main(backend: str, ranks: int = 2, device=None, lams=None,
         dtype=torch.float64, out=print) -> dict:
    """``backend``: ``"gloo"`` or ``"nccl"``, named by the caller;
    ``lams``: λ estimates for every rank's cycle instead of its own."""
    from poms_tpu_torch.parallel.launch import spawn

    mesh = mesh_of(ranks)
    out(f"processes={ranks} backend={backend} mesh={mesh}")
    spec = {"mesh": mesh, "device": device, "lams": lams, "dtype": dtype}
    rank_results = spawn(rank_steps, ranks, backend, args=(spec,))
    res = rank_results[0]
    prev = None
    for it, rn in enumerate(res["residuals"]):
        rho = f"  rho={rn / prev:.3f}" if prev else ""
        out(f"cycle {it + 1:2d}  |r| = {rn:.3e}{rho}")
        prev = rn
    out("OK" if res["ok"] else "NOT CONVERGED (increase cycles)")
    return {**res, "mesh": list(mesh), "launches": launches(rank_results)}


if __name__ == "__main__":
    backend, ranks, device = dist_cli()
    main(backend, ranks=ranks, device=device,
         dtype=torch.float32 if "--f32" in sys.argv else torch.float64)
