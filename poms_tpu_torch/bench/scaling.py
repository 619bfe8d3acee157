"""Weak and strong scaling of the distributed V-cycle.

Counterpart of ``poms_tpu/bench/scaling.py``.  Weak scaling grows the global
grid with the rank grid so that every rank keeps a fixed block; efficiency(N)
= t(1) / t(N).  Strong scaling keeps the global grid and grows the rank
grid; efficiency = t(1) / (N · t(N)).  Every point is one job of
``prod(mesh)`` ranks started by :mod:`poms_tpu_torch.parallel.launch`; each
rank builds the problem and ``DistributedMG``, warms one cycle and times
``iters`` more on the host clock (synchronised on the card); rank 0's time
is the point's.

Ranks that share one card (gloo) or the CPU show the wiring, not scaling:
their cycles compete for one device and every halo goes through host
memory.

    python -m poms_tpu_torch.bench.scaling [--weak|--strong] [out.json]
        (--backend gloo|nccl | --cpu) [--ranks MAX]
"""
from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass
from typing import List, Tuple

__all__ = ["run_weak_scaling", "run_strong_scaling", "ScalingPoint",
           "rank_time_cycles", "write_json"]


@dataclass
class ScalingPoint:
    mesh_shape: Tuple[int, ...]
    n_devices: int
    n_el: Tuple[int, ...]
    seconds_per_cycle: float
    efficiency: float  # against the one-rank point


def _mesh_shapes(dim: int, max_ranks: int) -> List[Tuple[int, ...]]:
    shapes = []
    n = 1
    while n <= max_ranks:
        shape = [1] * dim
        rem, a = n, 0
        while rem > 1:
            shape[a % dim] *= 2
            rem //= 2
            a += 1
        shapes.append(tuple(shape))
        n *= 2
    return shapes


def rank_time_cycles(spec: dict) -> float:
    """What every rank of a point runs: seconds per cycle."""
    import torch

    from poms_tpu_torch.examples import rank_device
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    dev = rank_device(spec["device"])
    prob = poisson_problem(spec["dim"], spec["n_el"], degree=spec["degree"],
                           device=dev)
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        kind=spec["smoother"], cheb_fraction=16.0))
    mg = DistributedMG(prob, num_levels=spec["levels"],
                       mesh_shape=spec["mesh"], cfg=cfg)
    b = mg.local(prob.b.interior)
    del prob
    x, rn = mg.step(torch.zeros_like(b), b)      # warm
    float(rn)
    t0 = time.perf_counter()
    for _ in range(spec["iters"]):
        x, rn = mg.step(x, b)
    float(rn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / spec["iters"]


def _point(spec, backend):
    from poms_tpu_torch.parallel.launch import spawn

    return spawn(rank_time_cycles, math.prod(spec["mesh"]), backend,
                 args=(spec,))[0]


def run_weak_scaling(dim: int = 3, n_el_local: int = 16, degree: int = 2,
                     num_levels: int = 2, max_ranks: int = 2,
                     smoother: str = "chebyshev", *, backend: str,
                     device=None, iters: int = 5, verbose: bool = True):
    points: List[ScalingPoint] = []
    t1 = None
    for mesh in _mesh_shapes(dim, max_ranks):
        n_el = tuple(n_el_local * m for m in mesh)
        sec = _point({"dim": dim, "n_el": n_el, "degree": degree,
                      "levels": num_levels, "mesh": mesh,
                      "smoother": smoother, "device": device,
                      "iters": iters}, backend)
        n = math.prod(mesh)
        t1 = sec if t1 is None else t1
        eff = t1 / sec if sec > 0 else 0.0
        points.append(ScalingPoint(mesh, n, n_el, sec, eff))
        if verbose:
            print(f"weak  mesh={mesh} ranks={n:2d} n_el={n_el} "
                  f"{sec * 1e3:8.2f} ms/cycle  eff={eff:5.2f}", flush=True)
    return points


def run_strong_scaling(dim: int = 2, n_el: int = 64, degree: int = 2,
                       num_levels: int = 3, max_ranks: int = 2,
                       smoother: str = "chebyshev", *, backend: str,
                       device=None, iters: int = 5, verbose: bool = True):
    points: List[ScalingPoint] = []
    t1 = None
    for mesh in _mesh_shapes(dim, max_ranks):
        sec = _point({"dim": dim, "n_el": n_el, "degree": degree,
                      "levels": num_levels, "mesh": mesh,
                      "smoother": smoother, "device": device,
                      "iters": iters}, backend)
        n = math.prod(mesh)
        t1 = sec if t1 is None else t1
        speedup = t1 / sec if sec > 0 else 0.0
        eff = speedup / n
        points.append(ScalingPoint(mesh, n, (n_el,) * dim, sec, eff))
        if verbose:
            print(f"strong mesh={mesh} ranks={n:2d} {sec * 1e3:8.2f} "
                  f"ms/cycle  speedup={speedup:5.2f} eff={eff:5.2f}",
                  flush=True)
    return points


def write_json(points: List[ScalingPoint], kind: str, path: str,
               backend: str, device) -> None:
    """A scaling run as a JSON artifact, with what ran it."""
    import torch

    on_card = device != "cpu"
    doc = {
        "kind": kind, "backend": backend,
        "platform": "gpu" if on_card else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "note": ("ranks sharing one device show the wiring and the "
                 "exchange counts, not scaling"),
        "points": [{"mesh_shape": list(pt.mesh_shape),
                    "n_devices": pt.n_devices, "n_el": list(pt.n_el),
                    "seconds_per_cycle": pt.seconds_per_cycle,
                    "efficiency": pt.efficiency} for pt in points],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


if __name__ == "__main__":
    from poms_tpu_torch.examples import dist_cli, int_args

    argv = sys.argv[1:]
    backend, ranks, device = dist_cli(argv)
    kind = "--strong" if "--strong" in argv else "--weak"
    pos = int_args(argv)
    kw = dict(max_ranks=ranks, backend=backend, device=device)
    points = (run_strong_scaling(**kw) if kind == "--strong"
              else run_weak_scaling(**kw))
    if pos:
        write_json(points, kind.lstrip("-"), pos[0], backend, device)
        print(f"wrote {pos[0]}")
