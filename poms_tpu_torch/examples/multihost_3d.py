"""A multi-process distributed 3D solve: V-cycle, W-cycle and FMG legs.

Counterpart of the JAX package's ``examples/multihost_3d.py``: one process a
rank (started by :mod:`poms_tpu_torch.parallel.launch`), 3D Poisson, p = 2,
three levels, Chebyshev(4) over [λmax/16, λmax], ν1 = ν2 = 1, 8 elements a
rank along each mesh axis, in f64 on every device as ``multihost_2d``
(whose docstring says why).  The default leg runs 10 V-cycles;
``--wcycle`` adds 8 W-cycles (γ = 2), ``--fmg`` a full-multigrid start
followed by 6 V-cycles.  Every leg builds its own
``DistributedMG`` (distributed transfers and the agglomerated tail).

Run:  python -m poms_tpu_torch.examples.multihost_3d [--wcycle] [--fmg]
          (--backend gloo|nccl | --cpu) [--ranks N]
"""
from __future__ import annotations

import sys

import torch

from poms_tpu_torch.examples import dist_cli, launches, rank_device
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem

__all__ = ["build", "main", "rank_legs", "legs_of", "mesh_of"]


def mesh_of(ranks: int):
    """The JAX example's 3D mesh over the grid axes, padded with 1s."""
    if ranks >= 8:
        return (2, 2, ranks // 4)
    if ranks >= 4:
        return (2, 2, 1)
    return (ranks, 1, 1)


def legs_of(wcycle: bool, fmg: bool):
    """(tag, γ, FMG start, cycles) of each leg."""
    legs = [("vcycle", 1, False, 10)]
    if wcycle:
        legs.append(("wcycle", 2, False, 8))
    if fmg:
        legs.append(("fmg+v", 1, True, 6))
    return legs


def build(mesh, gamma: int, device):
    """(problem, DistributedMG) of one leg on this rank."""
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = poisson_problem(3, tuple(8 * max(1, m) for m in mesh), degree=2,
                           dtype=torch.float64, device=device)
    cfg = CycleConfig(nu1=1, nu2=1, gamma=gamma, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    return prob, DistributedMG(prob, num_levels=3, mesh_shape=mesh, cfg=cfg)


def rank_legs(spec: dict) -> dict:
    """What every rank runs: each leg's cycles; per leg the FMG start's
    norm (or None), the history and whether it fell below 1e-6·‖b‖."""
    dev = rank_device(spec["device"])
    out = {}
    for tag, gamma, use_fmg, cycles in spec["legs"]:
        prob, mg = build(spec["mesh"], gamma, dev)
        lams = (spec.get("lams") or {}).get(tag)
        if lams is not None:
            mg.lams = tuple(lams)
        b_loc = mg.local(prob.b.interior)
        start = None
        if use_fmg:
            x, rn = mg.fmg_step(b_loc)
            start = float(rn)
        else:
            x = torch.zeros_like(b_loc)
        rns = []
        for _ in range(cycles):
            x, rn = mg.step(x, b_loc)
            rns.append(float(rn))
        b_norm = float(torch.linalg.vector_norm(prob.b.interior))
        out[tag] = {"fmg_start": start, "residuals": rns,
                    "ok": rns[-1] < 1e-6 * b_norm}
    return {"legs": out, "launches": launches()}


def main(wcycle: bool = False, fmg: bool = False, *, backend: str,
         ranks: int = 2, device=None, lams=None, out=print) -> dict:
    """``backend``: ``"gloo"`` or ``"nccl"``, named by the caller;
    ``lams``: {leg tag: λ estimates} for the legs' cycles."""
    from poms_tpu_torch.parallel.launch import spawn

    mesh = mesh_of(ranks)
    out(f"processes={ranks} backend={backend} mesh={mesh}")
    spec = {"mesh": mesh, "device": device, "lams": lams,
            "legs": legs_of(wcycle, fmg)}
    rank_results = spawn(rank_legs, ranks, backend, args=(spec,))
    res = rank_results[0]["legs"]
    for tag, leg in res.items():
        if leg["fmg_start"] is not None:
            out(f"[{tag}] FMG start  |r| = {leg['fmg_start']:.3e}")
        prev = None
        for it, rn in enumerate(leg["residuals"]):
            rho = f"  rho={rn / prev:.3f}" if prev else ""
            out(f"[{tag}] cycle {it + 1:2d}  |r| = {rn:.3e}{rho}")
            prev = rn
        out(f"[{tag}] " + ("OK" if leg["ok"]
                           else "NOT CONVERGED (increase cycles)"))
    all_ok = all(leg["ok"] for leg in res.values())
    out("ALL LEGS OK" if all_ok else "SOME LEG DID NOT CONVERGE")
    return {"legs": res, "all_ok": all_ok, "mesh": list(mesh),
            "launches": launches(rank_results)}


if __name__ == "__main__":
    backend, ranks, device = dist_cli()
    main("--wcycle" in sys.argv, "--fmg" in sys.argv, backend=backend,
         ranks=ranks, device=device)
