"""Port parity: the rank grid, halo exchange, distributed SpMV, reductions,
gathers and transfers of ``poms_tpu_torch/parallel`` on 4 gloo ranks.

The ranks are spawned once for the module (``parallel/launch.py``); one
worker per rank runs every case and returns its arrays, and each test
asserts one case.  The JAX package's side runs here, in the pytest process,
on the 8-device CPU mesh of ``tests/conftest.py`` (at the same mesh shape),
on the same seeded numpy inputs.  This module's top level imports no JAX:
the spawned ranks import it to find their worker.
"""
import numpy as np
import pytest
import torch

WORLD = 4
SPMV_CASES = {   # name: (dim, n_el, mesh_shape), Poisson p2
    "1d-32-4": (1, 32, (4,)),
    "2d-12-2x2": (2, 12, (2, 2)),
    "2d-10-2x2": (2, 10, (2, 2)),
    "3d-6-2x2x1": (3, 6, (2, 2, 1)),
}


# -- the ranks' side (no JAX) ------------------------------------------------
def _spec(mesh_shape, n_loc, pads, periodic):
    from poms_tpu_torch.parallel.halo import HaloSpec

    names = tuple(f"ax{a}" for a in range(len(n_loc)))
    return HaloSpec.build(names, mesh_shape, n_loc, pads, periodic)


def _halo(x, mesh_shape, pads, periodic):
    """Every rank's padded block after the exchange, gathered in rank
    order."""
    from poms_tpu_torch import convert
    from poms_tpu_torch.parallel.halo import pad_and_exchange

    n_loc = tuple(n // m for n, m in zip(x.shape, mesh_shape))
    spec = _spec(mesh_shape, n_loc, pads, periodic)
    x_loc = convert.local_block(x, mesh_shape, spec.grid.coords, x.shape)
    return pad_and_exchange(x_loc, spec).numpy()


def _spmv(band_t, x, mesh_shape, pads, periodic, overlap, offdiag=False):
    """dist_spmv (or dist_spmv_offdiag) on the identity-padded blocks, the
    global interior assembled on every rank."""
    from poms_tpu_torch import convert
    from poms_tpu_torch.parallel.dist import _pad_band_identity
    from poms_tpu_torch.parallel.halo import (dist_spmv, dist_spmv_offdiag,
                                              gather_blocks, local_starts)

    npts = x.shape
    N = tuple(-(-n // m) * m for n, m in zip(npts, mesh_shape))
    n_loc = tuple(n // m for n, m in zip(N, mesh_shape))
    spec = _spec(mesh_shape, n_loc, pads, periodic)
    band = _pad_band_identity(convert.tensor(band_t), npts, N, pads,
                              local_starts(spec), n_loc)
    x_loc = convert.local_block(x, mesh_shape, spec.grid.coords, N)
    if offdiag:
        y = dist_spmv_offdiag(band, x_loc, spec)
    else:
        y = dist_spmv(band, x_loc, spec, overlap)
    full = gather_blocks(y, spec.grid)
    return full[tuple(slice(0, n) for n in npts)].numpy()


def _reduce(a, b, mesh_shape):
    from poms_tpu_torch import convert
    from poms_tpu_torch.parallel.halo import dist_dot, dist_norm2

    n_loc = tuple(n // m for n, m in zip(a.shape, mesh_shape))
    spec = _spec(mesh_shape, n_loc, (1,) * a.ndim, (False,) * a.ndim)
    blocks = [convert.local_block(t, mesh_shape, spec.grid.coords, t.shape)
              for t in (a, b)]
    return (float(dist_dot(*blocks, spec)), float(dist_norm2(blocks[0],
                                                            spec)))


def _starts(mesh_shape, n_loc):
    from poms_tpu_torch.parallel.halo import local_starts

    return local_starts(_spec(mesh_shape, n_loc, (1,) * len(n_loc),
                              (False,) * len(n_loc)))


def _transfer(dim, n_el, degree, mesh_shape, periodic, seed):
    """A fine→coarse restriction and a coarse→fine prolongation with the
    add, distributed, against the serial K7 plain version."""
    from poms_tpu_torch import convert
    from poms_tpu_torch.models.bspline import (prolongation_interior_1d,
                                               prolongation_periodic_1d)
    from poms_tpu_torch.ops.transfer import apply_transfer, bands_from_dense
    from poms_tpu_torch.parallel.halo import (AxisSpec, RankGrid,
                                              gather_blocks)
    from poms_tpu_torch.parallel.transfers import (build_dist_transfer,
                                                   dist_apply_transfer)

    P1 = prolongation_periodic_1d if periodic else prolongation_interior_1d
    P1s = [P1(n_el // 2, degree) for _ in range(dim)]
    nf, nc = P1s[0].shape
    # padded sizes as DistributedMG makes them: N_f = 2 N_c, mesh multiples
    m = mesh_shape
    Nc = [nc if periodic else -(-max(-(-nf // 2), nc) // mm) * mm
          for mm in m]
    Nf = [2 * n for n in Nc] if not periodic else [nf] * dim
    grid = RankGrid.current(m)
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal((nf,) * dim)
    xc = rng.standard_normal((nc,) * dim)
    restrict = [build_dist_transfer(P.T, Nc[a], Nf[a], m[a], periodic)
                for a, P in enumerate(P1s)]
    prolong = [build_dist_transfer(P, Nf[a], Nc[a], m[a], periodic)
               for a, P in enumerate(P1s)]

    def axes(N):
        return tuple(AxisSpec(f"ax{a}", m[a], N[a] // m[a], 0, periodic)
                     for a in range(dim))

    xf_loc = convert.local_block(xf, m, grid.coords, Nf)
    xc_loc = convert.local_block(xc, m, grid.coords, Nc)
    r = dist_apply_transfer(restrict, xf_loc, axes(Nf), grid)
    p = dist_apply_transfer(prolong, xc_loc, axes(Nc), grid, add=xf_loc)
    r = gather_blocks(r, grid)[(slice(0, nc),) * dim]
    p = gather_blocks(p, grid)[(slice(0, nf),) * dim]
    R = tuple(bands_from_dense(P.T, device="cpu") for P in P1s)
    P = tuple(bands_from_dense(P, device="cpu") for P in P1s)
    want_r = apply_transfer(R, torch.as_tensor(xf))
    want_p = apply_transfer(P, torch.as_tensor(xc), add=torch.as_tensor(xf))
    return r.numpy(), want_r.numpy(), p.numpy(), want_p.numpy()


def _info():
    from poms_tpu_torch.parallel import bootstrap

    return bootstrap.process_info()


def _subgroup():
    """Ranks 2 and 3 as their own group, mesh (2,) periodic: the exchange
    addresses its peers by their ranks in the world, and the all_reduce
    stays inside the group.  The other ranks only join the group's
    creation."""
    import torch.distributed as dist

    from poms_tpu_torch.parallel.halo import (HaloSpec, RankGrid, dist_dot,
                                              pad_and_exchange)

    group = dist.new_group([2, 3])
    if dist.get_rank() < 2:
        return None
    grid = RankGrid.current((2,), group)
    spec = HaloSpec.build(("ax0",), (2,), (3,), (1,), (True,), grid)
    x = torch.arange(6.0)[3 * grid.rank:3 * grid.rank + 3]
    return (grid.rank, pad_and_exchange(x, spec).numpy(),
            float(dist_dot(x, x, spec)))


_FUNCS = {f.__name__: f for f in (_halo, _spmv, _reduce, _starts, _transfer,
                                  _info, _subgroup)}


def _worker(cases):
    """On every rank: each case's function on its arguments."""
    return {name: _FUNCS[fn](**kw) for name, fn, kw in cases}


# -- the pytest process: inputs, the JAX side, the ranks ---------------------
def _jax_exchange(x, mesh_shape, pads, periodic):
    """The JAX package's pad_and_exchange, per device block."""
    import jax
    from jax.sharding import PartitionSpec as P

    from poms_tpu.parallel.halo import HaloSpec, pad_and_exchange

    d = x.ndim
    names = tuple(f"ax{a}" for a in range(d))
    mesh = jax.make_mesh(mesh_shape, names)
    n_loc = tuple(n // m for n, m in zip(x.shape, mesh_shape))
    spec = HaloSpec.build(names, mesh_shape, n_loc, pads, periodic)
    f = jax.shard_map(lambda xl: pad_and_exchange(xl, spec), mesh=mesh,
                      in_specs=P(*names), out_specs=P(*names))
    out = np.asarray(jax.jit(f)(x))
    w = tuple(n + 2 * p for n, p in zip(n_loc, pads))
    blocks = []
    for r in range(int(np.prod(mesh_shape))):
        c = np.unravel_index(r, mesh_shape)
        blocks.append(out[tuple(slice(ci * wi, (ci + 1) * wi)
                                for ci, wi in zip(c, w))])
    return blocks


@pytest.fixture(scope="module")
def run():
    """(port results per rank, JAX references) for every case."""
    from poms_tpu.models.poisson import poisson_problem as jax_poisson
    from poms_tpu_torch.parallel.launch import start
    from tests.test_dist import _sharded_spmv
    from tests.test_stencil import random_stencil

    cases, ref = [], {}
    x16 = np.arange(16.0)
    x2d = np.random.default_rng(5).standard_normal((8, 12))
    for per in (False, True):
        cases.append((f"halo1d-{per}", "_halo",
                      dict(x=x16, mesh_shape=(4,), pads=(2,),
                           periodic=(per,))))
        ref[f"halo1d-{per}"] = _jax_exchange(x16, (4,), (2,), (per,))
        cases.append((f"halo2d-{per}", "_halo",
                      dict(x=x2d, mesh_shape=(2, 2), pads=(2, 3),
                           periodic=(per, per))))
        ref[f"halo2d-{per}"] = _jax_exchange(x2d, (2, 2), (2, 3),
                                             (per, per))
    spmv_inputs = {}
    for name, (dim, n_el, mesh) in SPMV_CASES.items():
        prob = jax_poisson(dim, n_el, degree=2)
        sp = prob.space
        x = np.random.default_rng(0).standard_normal(sp.npts)
        spmv_inputs[name] = (sp, np.asarray(prob.A.band_t), x, mesh)
    space, A = random_stencil((16,), (2,), (True,), seed=11)
    spmv_inputs["periodic-16-4"] = (
        space, np.asarray(A.band_t),
        np.random.default_rng(1).standard_normal(space.npts), (4,))
    for name, (sp, band, x, mesh) in spmv_inputs.items():
        ref[f"spmv-{name}"] = _sharded_spmv(sp, band, x, mesh)
        for overlap in (False, True):
            cases.append((f"spmv-{name}-{overlap}", "_spmv", dict(
                band_t=band, x=x, mesh_shape=mesh, pads=sp.pads,
                periodic=sp.periodic, overlap=overlap)))
        cases.append((f"offdiag-{name}", "_spmv", dict(
            band_t=band, x=x, mesh_shape=mesh, pads=sp.pads,
            periodic=sp.periodic, overlap=False, offdiag=True)))
        ref[f"offdiag-{name}"] = (band, x, sp.pads, sp.periodic)
    rng = np.random.default_rng(3)
    for name, shape, mesh in (("1d", (64,), (4,)), ("2d", (8, 6), (2, 2)),
                              ("3d", (4, 6, 5), (2, 2, 1))):
        a, b = rng.standard_normal(shape), rng.standard_normal(shape)
        cases.append((f"reduce-{name}", "_reduce",
                      dict(a=a, b=b, mesh_shape=mesh)))
        ref[f"reduce-{name}"] = (a, b)
    cases.append(("starts", "_starts", dict(mesh_shape=(2, 2),
                                            n_loc=(3, 5))))
    for name, kw in TRANSFER_CASES.items():
        cases.append((f"transfer-{name}", "_transfer", kw))
    cases.append(("info", "_info", {}))
    cases.append(("subgroup", "_subgroup", {}))
    job = start(_worker, WORLD, "gloo", args=(cases,), timeout=600)
    return job.results(), ref


TRANSFER_CASES = {
    "1d-p2": dict(dim=1, n_el=32, degree=2, mesh_shape=(4,), periodic=False,
                  seed=0),
    "2d-p3": dict(dim=2, n_el=24, degree=3, mesh_shape=(2, 2),
                  periodic=False, seed=1),
    "3d-p2": dict(dim=3, n_el=16, degree=2, mesh_shape=(2, 2, 1),
                  periodic=False, seed=2),
    "2d-periodic-p3": dict(dim=2, n_el=32, degree=3, mesh_shape=(2, 2),
                           periodic=True, seed=3),
}


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dim", [1, 2])
def test_halo_exchange_matches_jax(run, dim, periodic):
    """Every rank's ghosts equal the JAX package's ppermute result, bit for
    bit (1D mesh (4,); 2D mesh (2, 2) with corners and unequal pads)."""
    results, ref = run
    name = f"halo{dim}d-{periodic}"
    for r in range(WORLD):
        np.testing.assert_array_equal(results[r][name], ref[name][r])


def test_halo_exchange_unit(run):
    """Rank 1 of (4,) holds [4..8); its ghosts are [2, 3] and [8, 9]; the
    ends get zeros (the JAX package's unit test)."""
    results, _ = run
    out = [results[r]["halo1d-False"] for r in range(WORLD)]
    np.testing.assert_array_equal(out[1], [2, 3, 4, 5, 6, 7, 8, 9])
    np.testing.assert_array_equal(out[0][:2], [0, 0])
    np.testing.assert_array_equal(out[3][-2:], [0, 0])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", list(SPMV_CASES) + ["periodic-16-4"])
def test_dist_spmv_matches_jax(run, name, overlap):
    """dist_spmv, plain and overlap forms, against the JAX package's
    sharded SpMV (tests/test_dist.py::_sharded_spmv) at the same mesh:
    1e-13 relative in f64."""
    results, ref = run
    want = ref[f"spmv-{name}"]
    for r in range(WORLD):
        got = results[r][f"spmv-{name}-{overlap}"]
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", list(SPMV_CASES) + ["periodic-16-4"])
def test_dist_spmv_offdiag(run, name):
    """dist_spmv_offdiag against the plain off-diagonal SpMV of the serial
    port on the ghost-filled global field."""
    from poms_tpu_torch.core.vector import ghost_pad
    from poms_tpu_torch.ops.stencil import spmv_offdiag_plain

    results, ref = run
    band, x, pads, periodic = ref[f"offdiag-{name}"]
    x_pad = ghost_pad(torch.as_tensor(x), pads, periodic)
    want = spmv_offdiag_plain(torch.as_tensor(np.array(band)), x_pad,
                              x.shape, pads).numpy()
    np.testing.assert_allclose(results[0][f"offdiag-{name}"], want,
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", ["1d", "2d", "3d"])
def test_dist_dot_and_norm(run, name):
    """dist_dot / dist_norm2: a local vdot and one all_reduce, the same on
    every rank, within 1e-14 of Σ|terms| (the order of the sum differs)."""
    results, ref = run
    a, b = ref[f"reduce-{name}"]
    scale = np.abs(a * b).sum()
    for r in range(WORLD):
        dot, norm = results[r][f"reduce-{name}"]
        assert abs(dot - np.vdot(a, b)) <= 1e-14 * scale
        assert abs(norm ** 2 - np.vdot(a, a)) <= 1e-14 * np.vdot(a, a)
        assert (dot, norm) == results[0][f"reduce-{name}"]


def test_local_starts_row_major(run):
    """Rank r of mesh (2, 2) sits at unravel_index(r): starts are its
    coordinates times the block extents."""
    results, _ = run
    for r in range(WORLD):
        c = np.unravel_index(r, (2, 2))
        assert tuple(results[r]["starts"]) == (3 * c[0], 5 * c[1])


@pytest.mark.parametrize("name", list(TRANSFER_CASES))
def test_dist_transfer_matches_serial(run, name):
    """dist_apply_transfer (one exchange to the bands' widths, then K7's
    plain version on the block) ≡ the serial K7 plain version on the global
    field: restriction, and prolongation with the add, to f64 roundoff."""
    results, _ = run
    for r in range(WORLD):
        got_r, want_r, got_p, want_p = results[r][f"transfer-{name}"]
        np.testing.assert_allclose(got_r, want_r, rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-13, atol=1e-14)


def test_bootstrap_process_info(run):
    results, _ = run
    for r in range(WORLD):
        assert results[r]["info"] == {"rank": r, "world_size": WORLD,
                                      "backend": "gloo", "device": None}


def test_grid_of_a_subgroup(run):
    """A mesh over a subgroup (world ranks 2, 3): group ranks 0 and 1, the
    periodic ring's ghosts from the group's own blocks, the dot product
    summed over the group only."""
    results, _ = run
    assert results[0]["subgroup"] is None and results[1]["subgroup"] is None
    r0, x0, dot0 = results[2]["subgroup"]
    r1, x1, dot1 = results[3]["subgroup"]
    assert (r0, r1) == (0, 1)
    np.testing.assert_array_equal(x0, [5, 0, 1, 2, 3])
    np.testing.assert_array_equal(x1, [2, 3, 4, 5, 0])
    assert dot0 == dot1 == float(np.sum(np.arange(6.0) ** 2))


def test_gloo_backend_is_named():
    """The caller names the backend: none, or another, is refused."""
    from poms_tpu_torch.parallel import bootstrap, launch

    for backend in (None, "mpi"):
        with pytest.raises(ValueError, match="gloo"):
            bootstrap.initialize("file:///nonexistent", 1, 0, backend)
    with pytest.raises(ValueError, match="gloo"):
        launch.start(_info, 1, backend="auto")
    with pytest.raises(TypeError, match="backend"):
        launch.spawn(_info, 1)
