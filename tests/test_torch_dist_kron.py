"""Port parity: the distributed Kronecker-sum operator (apply, diagonal,
double-word residual and norm) and ``DistributedMG(operator="kron")``, on
4 gloo ranks, beside the JAX package's ``poms_tpu/parallel/kron.py`` and
``DistributedMG`` on the 8-device CPU mesh of ``tests/conftest.py``.

The ranks are spawned once for the module; each test asserts one case.
The distributed solves hold the tolerances of ``tests/test_torch_dist_mg.py``
(f64 cycles: 1e-9 of each entry plus 1e-14·‖b‖; f32 cycles, ``mixed``: the
count and, per case, a tolerance just above the difference read, the f32
cycles' rounding: :data:`MIXED_RTOL`).  This module's top level
imports no JAX: the spawned ranks import it to find their worker.
"""
import numpy as np
import pytest
import torch

WORLD = 4
APPLY = dict(npts=(16, 8), p=2, mesh=(2, 2))
KRON = dict(dim=2, n_el=16, degree=2, levels=2, mesh=(2, 2),
            operator="kron")
CASES = {
    "jacobi": dict(KRON, cfg=dict(kind="jacobi", omega=0.8, nu1=1, nu2=1),
                   tol=1e-10, maxiter=12),
    "rbgs": dict(KRON, cfg=dict(kind="rbgs", omega=1.0, nu1=1, nu2=1),
                 tol=1e-10, maxiter=12),
    "chebyshev": dict(KRON, cfg=dict(kind="chebyshev", cheb_fraction=16.0,
                                     nu1=1, nu2=1), tol=1e-10, maxiter=12),
    "rbgs-3d": dict(dim=3, n_el=8, degree=2, levels=2, mesh=(2, 2, 1),
                    operator="kron", cfg=dict(kind="rbgs", omega=1.0, nu1=1,
                                              nu2=1), tol=1e-10, maxiter=8),
    "mixed-f64": dict(KRON, cfg=dict(kind="rbgs", omega=1.0), tol=1e-10,
                      maxiter=60, options=dict(mixed=True,
                                               mixed_residual="f64")),
    "twofloat": dict(KRON, cfg=dict(kind="rbgs", omega=1.0), tol=1e-10,
                     maxiter=60, compiled=True,
                     options=dict(mixed=True, mixed_residual="twofloat")),
    "twofloat-inner2": dict(KRON, cfg=dict(kind="jacobi", omega=0.8, nu1=1,
                                           nu2=1), tol=1e-10, maxiter=40,
                            options=dict(mixed=True, inner_cycles=2,
                                         mixed_residual="twofloat")),
    "periodic": dict(KRON, problem="periodic",
                     cfg=dict(kind="jacobi", omega=0.8, nu1=1, nu2=1),
                     tol=1e-10, maxiter=60),
    "fmg": dict(KRON, cfg=dict(kind="jacobi", omega=0.8, nu1=1, nu2=1),
                tol=1e-10, maxiter=40, use_fmg=True),
    "compiled": dict(KRON, cfg=dict(kind="jacobi", omega=0.8), tol=1e-10,
                     maxiter=60, compiled=True),
}


# f32 cycles: the largest relative difference of an entry from the
# reference's, read in a 4-rank run on the CPU: mixed-f64 5.0e-6, twofloat
# 1.42e-4, twofloat-inner2 6.15e-3 (two f32 cycles a correction)
MIXED_RTOL = {"mixed-f64": 1e-5, "twofloat": 3e-4, "twofloat-inner2": 1e-2}


# -- the ranks' side (no JAX) ------------------------------------------------
def _operator(Ks, Ms, mesh, p, periodic):
    """(spec, the distinct bands per axis, labels) of Σ_a ⊗(K if b == a
    else M), the terms sharing band objects."""
    from poms_tpu_torch.ops.kron import band_labels
    from poms_tpu_torch.parallel.halo import HaloSpec

    d = len(Ks)
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
    npts = tuple(K.shape[0] for K in Ks)
    n_loc = tuple(n // m for n, m in zip(npts, mesh))
    spec = HaloSpec.build(tuple(f"ax{a}" for a in range(d)), mesh, n_loc,
                          (p,) * d, (periodic,) * d)
    return spec, tuple(by_axis), labels, terms


def _kron_apply(Ks, Ms, x, mesh, p, periodic):
    from poms_tpu_torch import convert
    from poms_tpu_torch.parallel.halo import gather_blocks
    from poms_tpu_torch.parallel.kron import dist_kron_apply, dist_kron_diag

    spec, bands, labels, _ = _operator(Ks, Ms, mesh, p, periodic)
    x_loc = convert.local_block(x, mesh, spec.grid.coords, x.shape)
    out = [dist_kron_apply(bands, labels, x_loc, spec, fused=f)
           for f in (True, False)]
    out.append(dist_kron_diag(bands, labels, spec))
    return [gather_blocks(t, spec.grid).numpy() for t in out]


def _residual_df(Ks, Ms, b, x, mesh, p):
    """The distributed double-word residual (fused and per-axis) and the
    serial plain K5 on the global field."""
    from poms_tpu_torch import convert
    from poms_tpu_torch.ops.twofloat import (residual_kron_df_plain,
                                             split_f64)
    from poms_tpu_torch.parallel.halo import gather_blocks
    from poms_tpu_torch.parallel.kron import dist_kron_residual_df

    spec, bands, labels, terms = _operator(Ks, Ms, mesh, p, False)
    split = {id(B): split_f64(B) for row in bands for B in row}
    bands_df = tuple(tuple(split[id(B)] for B in row) for row in bands)
    terms_df = [[split[id(B)] for B in term] for term in terms]
    loc = [split_f64(convert.local_block(t, mesh, spec.grid.coords,
                                         t.shape)) for t in (b, x)]
    got = []
    for fused in (True, False):
        words = dist_kron_residual_df(bands_df, labels, *loc[0], *loc[1],
                                      spec, fused=fused)
        got.append([gather_blocks(w, spec.grid).numpy() for w in words])
    want = residual_kron_df_plain(terms_df, *split_f64(torch.as_tensor(b)),
                                  *split_f64(torch.as_tensor(x)), (p,) * 2,
                                  labels=labels)
    return got, [w.numpy() for w in want]


def _norm_df(rh, rl, mesh):
    from poms_tpu_torch import convert
    from poms_tpu_torch.parallel.halo import HaloSpec
    from poms_tpu_torch.parallel.kron import dist_dw_norm2

    n_loc = tuple(n // m for n, m in zip(rh.shape, mesh))
    spec = HaloSpec.build(("ax0", "ax1"), mesh, n_loc, (1, 1),
                          (False, False))
    words = [convert.local_block(t, mesh, spec.grid.coords, t.shape)
             for t in (rh, rl)]
    return float(dist_dw_norm2(*words, spec))


_FUNCS = {f.__name__: f for f in (_kron_apply, _residual_df, _norm_df)}


def _worker(cases):
    """On every rank: each case's function (or solve)."""
    from poms_tpu_torch.bench.one_dist import solve_case

    return {name: (_FUNCS[fn](**kw) if fn in _FUNCS else solve_case(kw))
            for name, fn, kw in cases}


# -- the pytest process ------------------------------------------------------
def _random_bands(npts, p, seed):
    rng = np.random.default_rng(seed)
    Ks = [rng.standard_normal((n, 2 * p + 1)) for n in npts]
    Ms = [rng.standard_normal((n, 2 * p + 1)) for n in npts]
    return Ks, Ms


def _jax_kron_apply(Ks, Ms, x, mesh_shape, p, periodic):
    """The JAX package's dist_kron_apply and dist_kron_diag through
    shard_map (tests/test_dist_kron.py's construction)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from poms_tpu.core.kron import KroneckerSumOperator
    from poms_tpu.core.space import StencilVectorSpace
    from poms_tpu.parallel.halo import HaloSpec
    from poms_tpu.parallel.kron import dist_kron_apply, dist_kron_diag

    npts = x.shape
    d = len(npts)
    space = StencilVectorSpace(npts=npts, pads=(p,) * d, periodic=periodic,
                               dtype=jnp.float64)
    Kj = [jnp.asarray(K) for K in Ks]
    Mj = [jnp.asarray(M) for M in Ms]
    A = KroneckerSumOperator(space, [[Kj[b] if b == a else Mj[b]
                                      for b in range(d)] for a in range(d)])
    names = tuple(f"ax{a}" for a in range(d))
    mesh = jax.make_mesh(mesh_shape, names)
    n_loc = tuple(n // m for n, m in zip(npts, mesh_shape))
    spec = HaloSpec.build(names, mesh_shape, n_loc, (p,) * d,
                          (periodic,) * d)
    labels = A._band_labels()
    by_axis = []
    for a in range(d):
        distinct = [None] * (max(labels[a]) + 1)
        for r, term in enumerate(A.terms):
            distinct[labels[a][r]] = term[a]
        by_axis.append(tuple(distinct))
    f = jax.jit(jax.shard_map(
        lambda bl, xl: (dist_kron_apply(bl, labels, xl, spec),
                        dist_kron_diag(bl, labels, spec)),
        mesh=mesh, in_specs=(P(), P(*names)),
        out_specs=(P(*names), P(*names))))
    y, diag = f(tuple(by_axis), jnp.asarray(x))
    return np.asarray(y), np.asarray(diag)


@pytest.fixture(scope="module")
def run():
    from tests.test_torch_dist_mg import run_cases

    rng = np.random.default_rng(1)
    extra, ref = [], {}
    Ks, Ms = _random_bands(APPLY["npts"], APPLY["p"], 0)
    x = rng.standard_normal(APPLY["npts"])
    for per in (False, True):
        extra.append((f"apply-{per}", "_kron_apply",
                      dict(Ks=Ks, Ms=Ms, x=x, mesh=APPLY["mesh"],
                           p=APPLY["p"], periodic=per)))
        ref[f"apply-{per}"] = _jax_kron_apply(Ks, Ms, x, APPLY["mesh"],
                                              APPLY["p"], per)
    b = rng.standard_normal(APPLY["npts"])
    extra.append(("residual_df", "_residual_df",
                  dict(Ks=Ks, Ms=Ms, b=b, x=x, mesh=APPLY["mesh"],
                       p=APPLY["p"])))
    rh = rng.standard_normal((12, 8)).astype(np.float32)
    rl = (rng.standard_normal((12, 8)) * 2.0 ** -26).astype(np.float32)
    extra.append(("norm_df", "_norm_df", dict(rh=rh, rl=rl, mesh=(2, 2))))
    ref["norm_df"] = (rh, rl)
    results, jax_ref, states = run_cases(CASES, _worker, extra=extra)
    return results, dict(ref, **jax_ref), states


@pytest.mark.parametrize("periodic", [False, True])
def test_dist_kron_apply_matches_jax(run, periodic):
    """dist_kron_apply and dist_kron_diag on (2, 2) ranks against the JAX
    package's at the same mesh, 1e-13 relative; the fused and per-axis
    exchanges give the same bits."""
    results, ref, _ = run
    y_jax, diag_jax = ref[f"apply-{periodic}"]
    for r in range(WORLD):
        fused, per_axis, diag = results[r][f"apply-{periodic}"]
        np.testing.assert_allclose(fused, y_jax, rtol=1e-13, atol=1e-12)
        np.testing.assert_array_equal(fused, per_axis)
        np.testing.assert_allclose(diag, diag_jax, rtol=1e-13, atol=1e-14)


def test_dist_kron_residual_df_matches_serial(run):
    """The distributed double-word residual (both exchange forms) gives the
    serial plain K5's words, bit for bit: messages are exact and every
    point is summed in the serial order."""
    results, _, _ = run
    got, want = results[0]["residual_df"]
    for words in got:
        for g, w in zip(words, want):
            np.testing.assert_array_equal(g, w)


def test_dist_dw_norm2(run):
    """K6r's plain tree on each rank's words and one f64 all_reduce: within
    1e-14 of Σ|terms| of the exact sum of squares (the order differs)."""
    results, ref, _ = run
    rh, rl = ref["norm_df"]
    v = rh.astype(np.float64) + rl.astype(np.float64)
    exact = float(np.sum(v * v))
    for r in range(WORLD):
        got = results[r]["norm_df"]
        assert abs(got ** 2 - exact) <= 1e-14 * exact
        assert got == results[0]["norm_df"]


def test_pad_band_1d_identity_matches_jax():
    from poms_tpu.parallel.kron import pad_band_1d_identity as jax_pad
    from poms_tpu_torch.parallel.kron import pad_band_1d_identity

    B = np.arange(12.0).reshape(4, 3)
    Bp = pad_band_1d_identity(B, 6)
    np.testing.assert_array_equal(Bp, jax_pad(B, 6))
    np.testing.assert_array_equal(Bp[4:], [[0, 1, 0], [0, 1, 0]])
    assert pad_band_1d_identity(B, 4) is B


@pytest.mark.parametrize("name", list(CASES))
def test_dist_kron_history_matches_jax(run, name):
    from tests.test_torch_dist_mg import (F64_FLOOR, F64_RTOL,
                                          check_history)

    results, ref, states = run
    got = results[0][name]
    assert got["L_dist"] == states[name]["L_dist"]
    if CASES[name].get("options", {}).get("mixed", False):
        check_history(got, ref[name], MIXED_RTOL[name])
    else:
        check_history(got, ref[name], F64_RTOL, F64_FLOOR)
    for r in range(1, WORLD):
        assert results[r][name]["residuals"] == got["residuals"]


@pytest.mark.parametrize("name", ["mixed-f64", "twofloat",
                                  "twofloat-inner2", "periodic", "fmg",
                                  "compiled"])
def test_dist_kron_converges(run, name):
    """The solves that reach 1e-10 do so with a true f64 residual ≤ 2e-10
    (the reference's bound), as the reference's do."""
    results, ref, _ = run
    got = results[0][name]
    assert got["converged"] and ref[name]["converged"]
    assert got["true_residual"] <= 2e-10
    assert ref[name]["true_residual"] <= 2e-10


@pytest.mark.parametrize("name", ["twofloat", "compiled"])
def test_dist_kron_solve_compiled_matches_solve(run, name):
    results, _, _ = run
    got = results[0][name]
    assert got["compiled"]["iterations"] == got["iterations"]
    assert got["compiled"]["rn"] <= 1e-10
    assert got["compiled"]["same_bits"]


def test_dist_periodic_padding_rejected():
    """Periodic dims that would need grid padding are refused, as the JAX
    package refuses them (before any process group is needed)."""
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.periodic import periodic_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = periodic_problem(2, 12, degree=2, shift=1.0, device="cpu")
    with pytest.raises(ValueError, match="periodic dim"):
        DistributedMG(prob, num_levels=2, mesh_shape=(8, 1),
                      cfg=CycleConfig(smoother=SmootherConfig("jacobi",
                                                              0.8)))


def test_dist_mixed_residual_guard():
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = poisson_problem(2, 16, degree=2, device="cpu")
    with pytest.raises(ValueError, match="twofloat"):
        DistributedMG(prob, num_levels=2, mesh_shape=(2, 2), mixed=True,
                      mixed_residual="twofloat")
    prob32 = poisson_problem(2, 16, degree=2, dtype=torch.float32,
                             device="cpu")
    with pytest.raises(ValueError, match="f64"):
        DistributedMG(prob32, num_levels=2, mesh_shape=(2, 2), mixed=True)
