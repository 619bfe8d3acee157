"""``bench/scaling.py`` and ``bench/scaling_model.py`` on 2 gloo ranks.

The census counts the message directions a step posts through the port's
halo layer (``RankGrid.census``).  On a 2-rank grid it is held against the
JAX package's own count of the same exchanges: the ``ppermute`` s in the
jaxpr of its ``dist_kron_apply`` (fused and per-axis,
``tests/test_dist_kron.py::test_dist_kron_fused_exchange_fewer_collectives``
pins the fused 4 on every named axis) at the same mesh, counting only the
ppermutes of sharded axes (the JAX package permutes an axis of one device
onto itself; the port sends nothing there).  The model keeps the JAX
package's formulas: with the JAX constants put in, ``predict`` gives the JAX
``predict``'s numbers.  This module's top level imports no JAX: the spawned
ranks import it to find their worker.
"""
import math

import numpy as np
import pytest
import torch

CENSUS_CASES = {"2d": ((16, 8), (2, 1)), "3d": ((8, 8, 8), (2, 1, 1))}
P = 2


def _bands(npts, seed=0):
    rng = np.random.default_rng(seed)
    Ks = [rng.standard_normal((n, 2 * P + 1)) for n in npts]
    Ms = [rng.standard_normal((n, 2 * P + 1)) for n in npts]
    return Ks, Ms, rng.standard_normal(npts)


# -- the ranks' side (no JAX) ------------------------------------------------
def _apply_census(npts, mesh, fused):
    from poms_tpu_torch.ops.kron import band_labels
    from poms_tpu_torch.parallel.halo import HaloSpec, local_starts
    from poms_tpu_torch.parallel.kron import dist_kron_apply

    d = len(npts)
    Ks, Ms, x = _bands(npts)
    Kt = [torch.as_tensor(K) for K in Ks]
    Mt = [torch.as_tensor(M) for M in Ms]
    terms = [[Kt[b] if b == a else Mt[b] for b in range(d)]
             for a in range(d)]
    labels = band_labels(terms)
    by_axis = []
    for a in range(d):
        distinct = [None] * (max(labels[a]) + 1)
        for r, term in enumerate(terms):
            distinct[labels[a][r]] = term[a]
        by_axis.append(tuple(distinct))
    n_loc = tuple(n // m for n, m in zip(npts, mesh))
    spec = HaloSpec.build(tuple(f"ax{a}" for a in range(d)), mesh, n_loc,
                          (P,) * d, (False,) * d)
    x_loc = torch.as_tensor(x)[tuple(
        slice(s, s + n) for s, n in zip(local_starts(spec), n_loc))]
    spec.grid.census = []
    dist_kron_apply(by_axis, labels, x_loc, spec, fused=fused)
    return spec.grid.census


def _worker():
    from poms_tpu_torch.bench.scaling_model import rank_census

    out = {(name, fused): _apply_census(npts, mesh, fused)
           for name, (npts, mesh) in CENSUS_CASES.items()
           for fused in (True, False)}
    out["step"] = rank_census({"mesh": (2, 1, 1), "n_el_per_rank": 8,
                               "degree": 3, "levels": 3, "device": "cpu"})
    return out


@pytest.fixture(scope="module")
def ranks():
    from poms_tpu_torch.parallel.launch import spawn

    return spawn(_worker, 2, "gloo")


# -- the pytest process ------------------------------------------------------
def _jax_sharded_ppermutes(npts, mesh, fused):
    """ppermutes of the JAX dist_kron_apply's jaxpr on axes of more than
    one device, and all of them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from poms_tpu.core.kron import KroneckerSumOperator
    from poms_tpu.core.space import StencilVectorSpace
    from poms_tpu.parallel.halo import HaloSpec
    from poms_tpu.parallel.kron import dist_kron_apply

    d = len(npts)
    Ks, Ms, x = _bands(npts)
    space = StencilVectorSpace(npts=npts, pads=(P,) * d, periodic=False,
                               dtype=jnp.float64)
    Kj = [jnp.asarray(K) for K in Ks]
    Mj = [jnp.asarray(M) for M in Ms]
    A = KroneckerSumOperator(space, [[Kj[b] if b == a else Mj[b]
                                      for b in range(d)] for a in range(d)])
    labels = A._band_labels()
    bands = []
    for a in range(d):
        distinct = [None] * (max(labels[a]) + 1)
        for r, term in enumerate(A.terms):
            distinct[labels[a][r]] = term[a]
        bands.append(tuple(distinct))
    names = tuple(f"ax{a}" for a in range(d))
    mesh_j = jax.make_mesh(mesh, names)
    spec = HaloSpec.build(names, mesh, tuple(n // m for n, m in
                                             zip(npts, mesh)),
                          (P,) * d, (False,) * d)
    fn = jax.shard_map(lambda bl, xl: dist_kron_apply(bl, labels, xl, spec,
                                                      fused=fused),
                       mesh=mesh_j, in_specs=(Pspec(), Pspec(*names)),
                       out_specs=Pspec(*names))
    jaxpr = jax.make_jaxpr(fn)(tuple(bands), jnp.asarray(x))
    size = dict(zip(names, mesh))
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "ppermute":
                axes = eqn.params["axis_name"]
                axes = axes if isinstance(axes, tuple) else (axes,)
                found.append(math.prod(size[a] for a in axes))
            for val in eqn.params.values():
                for sub in (val if isinstance(val, (tuple, list))
                            else [val]):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return sum(s > 1 for s in found), len(found)


@pytest.mark.parametrize("name", list(CENSUS_CASES))
def test_census_counts_the_jax_exchanges(ranks, name):
    npts, mesh = CENSUS_CASES[name]
    counts = {}
    for fused in (True, False):
        recs = [r[(name, fused)] for r in ranks]
        assert all(rec["kind"] == "p2p" for rec in recs[0])
        port = len(recs[0])
        assert [len(rec) for rec in recs] == [port, port]
        sharded, every = _jax_sharded_ppermutes(npts, mesh, fused)
        assert port == sharded, (fused, port, sharded, every)
        # each rank sends one way and receives the other on a 2-rank axis
        assert sum(rec["sent"] for rec in recs[0]) == port // 2
        counts[fused] = port
    assert counts[True] < counts[False]
    if name == "2d":
        # the JAX pin: 4 ppermutes fused, 2 dims x (fwd + bwd); one dim
        # holds one device here
        assert _jax_sharded_ppermutes(npts, mesh, True)[1] == 4
        assert counts[True] == 2


def test_step_census_and_its_rows(ranks):
    from poms_tpu_torch.bench.scaling_model import _aggregate, classify

    steps = [r["step"] for r in ranks]
    assert steps[0]["L_dist"] >= 1
    p2p = [[rec for rec in s["records"] if rec["kind"] == "p2p"]
           for s in steps]
    assert len(p2p[0]) == len(p2p[1]) > 0
    sent = [sum(rec["bytes"] for rec in p if rec["sent"]) for p in p2p]
    assert sent[0] == sent[1] > 0            # each sends what the other gets
    assert all(rec["dim"] == 0 for rec in p2p[0])   # mesh (2, 1, 1)
    kinds = {rec["kind"] for rec in steps[0]["records"]}
    assert {"p2p", "all_reduce", "all_gather"} <= kinds
    rows = _aggregate(steps[0]["records"])
    doc = {"slabs": [r for r in rows if r["kind"] == "p2p"]}
    assert sum(r["count"] for r in doc["slabs"]) == len(p2p[0])
    cls = classify(doc)
    assert {c["axis"] for c in cls} == {0}
    assert all(c["thin"] >= 3 for c in cls)  # the pad (p = 3) or wider


def test_predict_keeps_the_jax_formulas(monkeypatch):
    from poms_tpu.bench import scaling_model as ref
    from poms_tpu_torch.bench import scaling_model as port

    monkeypatch.setattr(port, "T_MSG_S", ref.T_LAUNCH_S)
    cls = [{"level": lv, "axis": a, "thin": 3, "count": 4, "itemsize": 4,
            "shape": [3, 16, 16]} for lv in range(3) for a in range(3)]
    for mesh_dims in (1, 2, 3):
        got = port.predict(cls, 64, mesh_dims, 0.004,
                           link_gbps=ref.ICI_GBPS_PER_DIR)
        want = ref.predict(cls, [3, 3, 3], 64, mesh_dims, 0.004)
        for key, val in want.items():
            key = {"n_collectives_per_cycle": "messages_per_step"}.get(key,
                                                                       key)
            assert got[key] == pytest.approx(val, rel=1e-12), key
    # axes the census did not shard borrow axis 0's rows
    only0 = [c for c in cls if c["axis"] == 0]
    assert port.predict(only0, 64, 3, 0.004) == \
        port.predict([dict(c, axis=a) for c in only0 for a in range(3)],
                     64, 3, 0.004)
    assert port.NVLINK_GBPS_PER_DIR == 450.0


def test_weak_scaling_points_on_gloo_ranks():
    from poms_tpu_torch.bench.scaling import _mesh_shapes, run_weak_scaling

    assert _mesh_shapes(3, 8) == [(1, 1, 1), (2, 1, 1), (2, 2, 1),
                                  (2, 2, 2)]
    pts = run_weak_scaling(dim=2, n_el_local=8, max_ranks=2,
                           backend="gloo", device="cpu", iters=2,
                           verbose=False)
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[1].n_el == (16, 8) and pts[0].efficiency == 1.0
    assert all(p.seconds_per_cycle > 0 for p in pts)
