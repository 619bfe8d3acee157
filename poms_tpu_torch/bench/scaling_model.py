"""Analytic weak-scaling model of the distributed production solve.

Counterpart of ``poms_tpu/bench/scaling_model.py``, with the JAX package's
formulas and the card's constants:

1. **Census** (measured, not derived): build the production distributed
   configuration (Kronecker-sum operator, twofloat defect correction,
   Chebyshev(4) cycles) on ranks started by
   :mod:`poms_tpu_torch.parallel.launch`, run ONE outer step with the rank
   grid's ``census`` on (``parallel/halo.py``: one record per message
   direction posted, per slab, and per collective) and aggregate the
   records by shape and dtype.  The step is the fused form that
   ``DistributedMG`` runs (``parallel/kron.py``); nothing is traced, so the
   census cannot disagree with the step's signature (the JAX package's
   census traces a 4-argument step against the 7-argument one and cannot
   be regenerated; that fault is not copied).
2. **Rescale**: each halo slab has one thin dim (the pad width) and scales
   with the block in the others; its bytes at a block of b³ a rank follow.
   Axes the census' rank grid does not shard borrow axis 0's rows (a cubic
   block's exchanges are the same on every axis).
3. **Model**:
       T_comm(b, mesh) = Σ_slabs bytes / BW_link + n_msg · t_msg
       eff_no_overlap  = T_comp / (T_comp + T_comm)
       eff_overlap     = T_comp / max(T_comp, T_comm)   (upper bound)
   with T_comp the port's own measured time of one outer step at the block
   (``bench/attr_iter.py``'s ``step``, or the headline example's ms per
   iteration) and BW_link NVIDIA's published NVLink 4 rate of an H100 SXM,
   900 GB/s aggregate, 450 GB/s a direction (a specification, not a
   measurement); t_msg is an assumed per-message latency.

    python -m poms_tpu_torch.bench.scaling_model [out.json]
        (--backend gloo|nccl | --cpu) [--ranks N] [--t-comp-ms T]
        [--block B]
"""
from __future__ import annotations

import json
import math
import sys

__all__ = ["census", "rank_census", "classify", "predict",
           "NVLINK_GBPS_PER_DIR", "T_MSG_S"]

NVLINK_GBPS_PER_DIR = 450.0  # H100 SXM, NVLink 4: 900 GB/s both ways (spec)
T_MSG_S = 1e-5               # assumed per-message latency, not measured


def rank_census(spec: dict) -> dict:
    """What every rank runs: the production step's exchanges, recorded."""
    import torch

    from poms_tpu_torch.examples import rank_device
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    dev = rank_device(spec["device"])
    mesh = tuple(spec["mesh"])
    n_el = tuple(spec["n_el_per_rank"] * m for m in mesh)
    prob = poisson_problem(len(mesh), n_el, degree=spec["degree"],
                           dtype=torch.float64, operator="kron", device=dev)
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0, cheb_degree=4))
    mg = DistributedMG(prob, num_levels=spec["levels"], mesh_shape=mesh,
                       cfg=cfg, mixed=True, operator="kron",
                       mixed_residual="twofloat")
    state, consts, step, _ = mg._start(prob.b)
    mg.grid.census = []
    step(*state, *consts)
    records, mg.grid.census = mg.grid.census, None
    return {"records": records, "L_dist": mg.L_dist,
            "pads": [prob.degree] * len(mesh)}


def _aggregate(records):
    agg = {}
    for r in records:
        key = (r["kind"], tuple(r["shape"]), r["dtype"], r.get("dim"))
        row = agg.setdefault(key, {"kind": r["kind"], "shape": list(key[1]),
                                   "dtype": key[2], "dim": key[3],
                                   "count": 0, "sent": 0, "bytes_sent": 0})
        row["count"] += 1
        if r.get("sent", True):
            row["sent"] += 1
            row["bytes_sent"] += r["bytes"]
    return sorted(agg.values(), key=lambda r: (r["kind"], r["dim"] or 0,
                                               r["shape"]))


def census(mesh_shape=(2, 1, 1), n_el_per_rank: int = 8, degree: int = 3,
           levels: int = 3, *, backend: str, device=None) -> dict:
    """One production outer step on ``prod(mesh_shape)`` ranks, counted.

    ``slabs``: the ``p2p`` message directions of rank 0 aggregated by shape,
    dtype and dim (``count``: directions posted, as the JAX package counts
    ``ppermute`` s; ``sent``/``bytes_sent``: those this rank had a peer
    for); ``collectives``: the ``all_reduce`` and ``all_gather`` calls;
    ``messages_per_rank``: every rank's posted directions (equal on all)."""
    from poms_tpu_torch.parallel.launch import spawn

    spec = {"mesh": tuple(mesh_shape), "n_el_per_rank": n_el_per_rank,
            "degree": degree, "levels": levels, "device": device}
    outs = spawn(rank_census, math.prod(mesh_shape), backend, args=(spec,))
    rows = _aggregate(outs[0]["records"])
    return {"mesh_shape": list(mesh_shape), "n_el_per_rank": n_el_per_rank,
            "degree": degree, "dist_levels": outs[0]["L_dist"],
            "pads": outs[0]["pads"],
            "slabs": [r for r in rows if r["kind"] == "p2p"],
            "collectives": [r for r in rows if r["kind"] != "p2p"],
            "messages_per_rank": [sum(r["kind"] == "p2p"
                                      for r in o["records"])
                                  for o in outs],
            "bytes_sent_per_rank": [sum(r["bytes"] for r in o["records"]
                                        if r["kind"] == "p2p" and r["sent"])
                                    for o in outs]}


def classify(census_doc):
    """Label each slab row with (level, axis): the thin dim is the exchange
    axis, the log-ratio of the thick extents to the finest rounds to the
    level."""
    base = max(max(row["shape"]) for row in census_doc["slabs"]
               if row["shape"])
    out = []
    for row in census_doc["slabs"]:
        shape = row["shape"]
        itemsize = {"float64": 8, "bfloat16": 2}.get(row["dtype"], 4)
        axis = row["dim"]
        thick = [shape[a] for a in range(len(shape)) if a != axis]
        tmean = sum(thick) / max(len(thick), 1)
        level = min(3, max(0, round(math.log2(base / max(tmean, 1)))))
        out.append({"level": level, "axis": axis, "thin": shape[axis],
                    "count": row["count"], "itemsize": itemsize,
                    "shape": shape})
    return out


def predict(classified, block_edge: int, mesh_dims: int, t_comp: float,
            link_gbps: float = NVLINK_GBPS_PER_DIR):
    """Per-step communication time and efficiency at a b³ block a rank with
    ``mesh_dims`` grid axes sharded.  Slabs of different axes move at once
    on their own links (``t_comm_concurrent_s``); the serialised sum is the
    pessimistic variant."""
    axes_seen = {row["axis"] for row in classified}
    rows = list(classified)
    for a in range(mesh_dims):
        if a not in axes_seen:     # borrow axis 0's exchanges (symmetry)
            rows += [{**row, "axis": a} for row in classified
                     if row["axis"] == 0]
    per_axis_bytes = {}
    n_msg = 0
    for row in rows:
        if row["axis"] >= mesh_dims:
            continue
        edge = block_edge >> row["level"]
        nbytes = row["thin"] * edge * edge * row["itemsize"] * row["count"]
        per_axis_bytes[row["axis"]] = (per_axis_bytes.get(row["axis"], 0.0)
                                       + nbytes)
        n_msg += row["count"]
    bw = link_gbps * 1e9
    t_serial = sum(per_axis_bytes.values()) / bw + n_msg * T_MSG_S
    t_conc = (max(per_axis_bytes.values(), default=0.0) / bw
              + n_msg * T_MSG_S)
    return {
        "t_comp_s": t_comp,
        "t_comm_serial_s": t_serial,
        "t_comm_concurrent_s": t_conc,
        "eff_no_overlap": t_comp / (t_comp + t_conc),
        "eff_no_overlap_serial_links": t_comp / (t_comp + t_serial),
        "eff_full_overlap": t_comp / max(t_comp, t_conc),
        "messages_per_step": n_msg,
    }


RANKS_TO_MESH_DIMS = {2: 1, 4: 2, 8: 3, 16: 3}


def main():
    from poms_tpu_torch.examples import dist_cli, flag, int_args

    argv = sys.argv[1:]
    backend, ranks, device = dist_cli(argv)
    block = flag(argv, "--block", int, 128)
    t_comp_ms = flag(argv, "--t-comp-ms", float)
    pos = int_args(argv)
    mesh = (ranks,) + (1,) * 2 if ranks < 8 else (2, 2, ranks // 4)
    doc = census(mesh, backend=backend, device=device)
    if t_comp_ms is None:
        from poms_tpu_torch.bench.attr_iter import run

        t_comp_ms = run(block, 3, "dc", device)["step_s"] * 1e3
    cls = classify(doc)
    doc["classified"] = cls
    doc["model_constants"] = {"link_gbps_per_dir": NVLINK_GBPS_PER_DIR,
                              "t_msg_s": T_MSG_S, "block_edge": block,
                              "t_comp_measured_s": t_comp_ms * 1e-3}
    doc["prediction"] = {str(c): predict(cls, block, md, t_comp_ms * 1e-3)
                         for c, md in RANKS_TO_MESH_DIMS.items()}
    print(f"dist_levels={doc['dist_levels']} message directions/step="
          f"{doc['messages_per_rank'][0]} (rank 0)")
    for c, r in doc["prediction"].items():
        print(f"{c:>2s} ranks at {block}^3 a rank: eff_no_overlap "
              f"{r['eff_no_overlap']:.3f}, eff_full_overlap "
              f"{r['eff_full_overlap']:.3f}")
    if pos:
        with open(pos[0], "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {pos[0]}")


if __name__ == "__main__":
    main()
