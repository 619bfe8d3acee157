"""Block-partitioned 2D V-cycles over the ranks of a process group.

Counterpart of the JAX package's ``examples/distributed_2d.py``: the banded
2D Poisson problem (p = 3, two levels, Jacobi ω = 0.8) solved by
``DistributedMG`` on a (m1, m2) rank grid, one process per rank started by
:mod:`poms_tpu_torch.parallel.launch`; halos move by ``torch.distributed``
point-to-point messages, norms are ``all_reduce`` s.  Prints the history
and its largest drift from the serial ``MultigridSolver``'s.

Run:  python -m poms_tpu_torch.examples.distributed_2d [n_el] [m1] [m2]
          (--backend gloo|nccl | --cpu) [--ranks N]
"""
from __future__ import annotations

from poms_tpu_torch.examples import (dist_cli, int_args, launches,
                                     rank_device)
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import poisson_problem

__all__ = ["build", "main", "rank_solve", "mesh_of"]

CFG = CycleConfig(smoother=SmootherConfig(kind="jacobi", omega=0.8))


def mesh_of(ranks: int, m1=None, m2=None):
    """The JAX example's mesh rule, over ranks instead of devices."""
    if m1 is None:
        m1 = 2 if ranks >= 2 else 1
        m2 = max(1, min(ranks // m1, 4))
    return m1, m2


def build(n_el: int, mesh, device=None):
    """(problem, DistributedMG) on this rank (inside a process group)."""
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = poisson_problem(2, n_el, degree=3, device=device)
    return prob, DistributedMG(prob, num_levels=2, mesh_shape=mesh, cfg=CFG)


def rank_solve(spec: dict) -> dict:
    """What every rank runs: the distributed solve; its history."""
    _, mg = build(spec["n_el"], spec["mesh"], rank_device(spec["device"]))
    res = mg.solve(tol=1e-10, maxiter=60)
    return {"residuals": list(res.residuals), "iterations": res.iterations,
            "converged": res.converged, "launches": launches()}


def main(n_el: int = 32, m1=None, m2=None, *, backend: str,
         ranks: int = 2, device=None, out=print) -> dict:
    """``backend``: ``"gloo"`` or ``"nccl"``, named by the caller."""
    from poms_tpu_torch.parallel.launch import spawn

    m1, m2 = mesh_of(ranks, m1, m2)
    out(f"ranks: {ranks} ({backend}); mesh = ({m1}, {m2})")
    spec = {"n_el": n_el, "mesh": (m1, m2), "device": device}
    rank_results = spawn(rank_solve, ranks, backend, args=(spec,))
    res = rank_results[0]
    for i, r in enumerate(res["residuals"]):
        out(f"cycle {i:3d}  ||r|| = {r:.6e}")
    prob = poisson_problem(2, n_el, degree=3,
                           device="cpu" if device == "cpu" else None)
    serial = MultigridSolver(prob, num_levels=2, cfg=CFG).solve(
        tol=1e-10, maxiter=60)
    drift = max(abs(a - b) for a, b in zip(res["residuals"],
                                           serial.residuals))
    out(f"max |distributed - serial| residual drift: {drift:.3e}")
    return {**res, "mesh": [m1, m2], "serial": list(serial.residuals),
            "drift": drift, "launches": launches(rank_results)}


if __name__ == "__main__":
    backend, ranks, device = dist_cli()
    main(*int_args(n=3), backend=backend, ranks=ranks, device=device)
