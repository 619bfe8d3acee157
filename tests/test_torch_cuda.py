"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -o addopts=''
"""
import numpy as np
import pytest
import torch

from poms_tpu_torch.bench import kernel_probe as kp
from poms_tpu_torch.bench.kernel_probe import (make_band, stream_probe,
                                               stream_probe_plain)
from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.bspline import (prolongation_interior_1d,
                                           prolongation_periodic_1d)
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.periodic import periodic_problem
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import counters, twofloat
from poms_tpu_torch.ops import transfer as k7
from poms_tpu_torch.ops.kron import (MODES as K1_MODES, RT_PASSES,
                                     build_kron_plan, kron_apply,
                                     kron_apply_plain, kron_mode,
                                     kron_mode_plain, rows_options)
from poms_tpu_torch.ops.stencil import (MODES, color_mask, stencil_apply,
                                        stencil_apply_plain)
from poms_tpu_torch.ops.stencil_v2 import (pack_band_v2, stencil_apply_v2,
                                           stencil_apply_v2_plain)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SHAPES = [((9, 9, 9), 3, False), ((17, 33, 65), 3, False),
          ((129, 129, 129), 3, False), ((8, 12, 130), 2, False),
          ((10, 130, 140), 3, False), ((8, 8, 128), 2, True),
          ((6, 64, 96), 1, False), ((5, 7, 9), 3, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(npts, p, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    Ks = [torch.as_tensor(rng.standard_normal((n, 2 * p + 1)) / 4,
                          dtype=dtype, device=dev) for n in npts]
    Ms = [torch.as_tensor(rng.standard_normal((n, 2 * p + 1)) / 4,
                          dtype=dtype, device=dev) for n in npts]
    terms = [[Ks[b] if b == a else Ms[b] for b in range(3)] for a in range(3)]
    x = torch.as_tensor(rng.standard_normal(npts), dtype=dtype, device=dev)
    return terms, x


@pytest.mark.parametrize("npts,p,periodic", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_k1_kernel_matches_plain(dev, npts, p, periodic, dtype, tol):
    """max|Δ|/max|y| ≤ 1e-5 (f32), 1e-12 (f64): other summation order,
    and the kernel contracts multiply-adds into FMAs."""
    terms, x = _operands(npts, p, dtype, dev, seed=sum(npts))
    args = (npts, (p,) * 3, (periodic,) * 3)
    before = kron_apply.launches
    y = kron_apply(terms, x, *args)
    torch.cuda.synchronize()
    assert kron_apply.launches == before + 1
    want = kron_apply_plain(terms, x, *args)
    assert float((y - want).abs().max() / want.abs().max()) <= tol


def test_k1_kernel_refuses_what_it_lacks(dev):
    terms, x = _operands((6, 7, 8), 1, torch.float32, dev)
    with pytest.raises(TypeError):
        kron_apply([[B.half() for B in t] for t in terms], x.half(),
                   (6, 7, 8), (1,) * 3, (False,) * 3)
    with pytest.raises(ValueError):
        kron_apply(terms, x[:5], (6, 7, 8), (1,) * 3, (False,) * 3)
    # a 2D field is lifted to 3D and applied
    terms2 = [[t[1], t[2]] for t in terms[1:]]
    y = kron_apply(terms2, x[0], (7, 8), (1, 1), (False, False))
    want = kron_apply_plain(terms2, x[0], (7, 8), (1, 1), (False, False))
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


def test_k1_refused_launch_raises(dev):
    """One past K1r's widest half-width in f32 (219): not even its smallest
    block fits a block's shared memory, the plan is refused, the wrapper
    raises, and the next launch runs."""
    from poms_tpu_torch.ops import kron as k1
    p = k1.widest_half_width(k1.k1r_smem(4)) + 1
    terms, x = _operands((4, 5, 6), p, torch.float32, dev)
    before = dict(kron_mode.launches)
    with pytest.raises(RuntimeError, match="bytes of shared memory"):
        kron_apply(terms, x, (4, 5, 6), (p,) * 3, (False,) * 3)
    assert kron_mode.launches == before
    terms, x = _operands((6, 7, 8), 1, torch.float32, dev)
    y = kron_apply(terms, x, (6, 7, 8), (1,) * 3, (False,) * 3)
    want = kron_apply_plain(terms, x, (6, 7, 8), (1,) * 3, (False,) * 3)
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


# npts, pads, periodic, number of sharing-free terms (0: Poisson-shaped)
K1_MODE_SHAPES = [((9, 9, 9), (3, 3, 3), (False,) * 3, 0),
                  ((17, 33, 65), (3, 3, 3), (False,) * 3, 0),
                  ((12, 20, 40), (2, 3, 1), (True, False, True), 0),
                  ((300, 257), (3, 3), (False, False), 0),
                  ((5000,), (2,), (True,), 0),
                  ((20, 21, 22), (2, 2, 2), (False,) * 3, 4),
                  ((12, 13, 14), (5, 4, 5), (False,) * 3, 0)]


def _mode_operands(npts, pads, dtype, dev, free, seed=0):
    rng = np.random.default_rng(seed)
    d = len(npts)

    def band(n, p):
        return torch.as_tensor(
            rng.standard_normal((n, 2 * p + 1)) / 4
            + 2.0 * (np.arange(2 * p + 1) == p), dtype=dtype, device=dev)

    if free:
        terms = [[band(n, p) for n, p in zip(npts, pads)]
                 for _ in range(free)]
    else:
        Ks = [band(n, p) for n, p in zip(npts, pads)]
        Ms = [band(n, p) for n, p in zip(npts, pads)]
        terms = [[Ks[b] if b == a else Ms[b] for b in range(d)]
                 for a in range(d)]
    return terms, [torch.as_tensor(rng.standard_normal(npts), dtype=dtype,
                                   device=dev) for _ in range(3)]


@pytest.mark.parametrize("npts,pads,periodic,free", K1_MODE_SHAPES)
@pytest.mark.parametrize("mode", K1_MODES + ("cheb0",))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_k1_modes_match_plain(dev, npts, pads, periodic, free, mode, dtype,
                              tol):
    """Every mode in 1D/2D/3D, mixed pads and periodicity, a strided x and a
    4-term operator that takes two runs of terms: within K1's tolerance of
    the plain version (summation order, FMA); the compiled kernel at
    half-widths 1-3 at both micro-tile heights (two rows a thread and
    one), K1r (three launches a run) at 5."""
    terms, (x, b, d) = _mode_operands(npts, pads, dtype, dev, free,
                                      seed=sum(npts))
    runtime = max(pads) > 3
    per_run = len(RT_PASSES) if runtime else 1
    kw = {}
    if mode in ("residual", "cheb", "cheb0"):
        kw["b"] = b
    if mode == "cheb":
        kw.update(d=d, c1=0.3, c2=0.7)
    if mode == "cheb0":
        mode, kw = "cheb", dict(kw, d=None, c1=0.0, c2=0.7)
    # x as the interior view of a padded field: the kernel takes strides
    x_view = ghost_pad(x, pads, (False,) * len(npts))[
        tuple(slice(p, p + n) for n, p in zip(npts, pads))]
    for trows in [None] if runtime else [(R,) for R in rows_options()]:
        plan = build_kron_plan(terms, npts, pads, periodic, trows=trows)
        assert plan.runtime == runtime
        assert trows is None or (plan.trows,) == trows
        before = dict(kron_mode.launches)
        kw_k = dict(kw, d=d.clone()) if kw.get("d") is not None else kw
        got = kron_mode(mode, plan, x_view, **kw_k)
        torch.cuda.synchronize()
        # per run of terms one launch (K1r: one a pass): the last run's in
        # ``mode``, the others' ``apply``
        before[mode] += per_run
        before["apply"] += per_run * (len(plan.plans) - 1)
        assert kron_mode.launches == before
        want = kron_mode_plain(mode, terms, x, npts, pads, periodic,
                               diag=plan.diagonal(), **kw)
        if mode != "cheb":
            got, want = (got,), (want,)
        else:
            assert kw_k.get("d") is None or got[1] is kw_k["d"]  # in place
        for g, w in zip(got, want):
            assert float((g - w).abs().max() / w.abs().max()) <= tol, trows


K5_SHAPES = [((17, 17, 17), (3, 3, 3), (False,) * 3),
             ((17, 33, 65), (3, 3, 3), (False,) * 3),
             ((8, 8, 128), (2, 2, 2), (True,) * 3),
             ((6, 5, 9), (3, 2, 1), (False, True, False)),
             ((300, 257), (3, 3), (False, False)),
             ((5000,), (2,), (True,))]


@pytest.mark.parametrize("npts,pads,periodic", K5_SHAPES)
@pytest.mark.parametrize("flags", ["full", "zero"])
def test_k5_kernel_is_bit_equal_to_plain(dev, npts, pads, periodic, flags):
    """The double-word residual's words equal the plain version's, with
    b and x_l given and with the zero flags of the A·p call."""
    terms, (x, b, _) = _mode_operands(npts, pads, torch.float64, dev, 0,
                                      seed=sum(npts) + 1)
    split = {id(B): twofloat.split_f64(B) for t in terms for B in t}
    tdf = [[split[id(B)] for B in t] for t in terms]
    (xh, xl), (bh, bl) = twofloat.split_f64(x), twofloat.split_f64(b)
    zero = torch.zeros_like(xh)
    given, explicit = {"full": ((bh, bl, xh, xl), (bh, bl, xh, xl)),
                       "zero": ((None, None, xh, None),
                                (zero, zero, xh, zero))}[flags]
    before = twofloat.residual_kron_df.launches
    got = twofloat.residual_kron_df(tdf, *given, pads, periodic=periodic)
    torch.cuda.synchronize()
    assert twofloat.residual_kron_df.launches == before + 1
    want = twofloat.residual_kron_df_plain(tdf, *explicit, pads, None,
                                           periodic)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("four", [False, True])
def test_k5_spills_nothing(dev, four):
    """At half-width 3 the compiled K5 keeps its values in registers (no
    local memory) and its 129^3 launch fits an SM, with four histories as
    well."""
    npts, pads = (129,) * 3, (3,) * 3
    if four:
        tdf = _periodic_df_terms(npts, pads, dev, seed=5)
    else:
        terms, _ = _mode_operands(npts, pads, torch.float64, dev, 0, seed=5)
        split = {id(B): twofloat.split_f64(B) for t in terms for B in t}
        tdf = [[split[id(B)] for B in t] for t in terms]
    plan = twofloat.build_kron_df_plan(tdf, npts, pads)
    res = twofloat.k5_resources(plan)
    assert res["local_bytes"] == 0, res
    assert 0 < res["registers"] <= 255 and res["blocks_per_sm"] >= 1, res


def test_k5_refuses_what_it_lacks(dev):
    """Five sharing-free terms exceed one launch (2 u partials): they run in
    three launches chained through the sum so far, bit-equal to the single
    pass; a float64 field and a half-width past K5r's widest (138) are
    refused."""
    rng = np.random.default_rng(0)
    free = [[twofloat.split_f64(torch.as_tensor(
        rng.standard_normal((9, 3)), device=dev)) for _ in range(2)]
        for _ in range(5)]
    xh = torch.as_tensor(rng.standard_normal((9, 9)), dtype=torch.float32,
                         device=dev)
    before = twofloat.residual_kron_df.launches
    got = twofloat.residual_kron_df(free, None, None, xh, None, (1, 1))
    torch.cuda.synchronize()
    assert twofloat.residual_kron_df.launches == before + 3
    zero = torch.zeros_like(xh)
    want = twofloat.residual_kron_df_plain(free, zero, zero, xh, zero, (1, 1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        twofloat.residual_kron_df(free[:1], None, None, xh.double(), None,
                                  (1, 1))
    wide = [[twofloat.split_f64(torch.as_tensor(
        rng.standard_normal((20, 279)), device=dev)) for _ in range(2)]]
    with pytest.raises(RuntimeError, match="bytes of shared memory"):
        twofloat.residual_kron_df(wide, None, None,
                                  torch.zeros((20, 20), device=dev), None,
                                  (139, 139))


@pytest.mark.parametrize("nterms,p", [(5, 8), (6, 8), (5, 3), (6, 2)])
def test_k5_chained_launches_are_bit_equal_to_the_single_pass(dev, nterms,
                                                              p):
    """Operators of 5 and 6 sharing-free terms on the compiled K5 (at 2 and
    3) and on K5r (at 8): one launch per run of terms (K5r: one a pass),
    each run adding onto the sum of the runs before it, the last forming
    b - sum; the words equal the single pass's, also as A.p."""
    npts = (p + 12, p + 13, 2 * p + 20)
    terms, (x, b, _) = _mode_operands(npts, (p,) * 3, torch.float64, dev,
                                      nterms, seed=nterms + p)
    tdf = [[twofloat.split_f64(B) for B in t] for t in terms]
    (xh, xl), (bh, bl) = twofloat.split_f64(x), twofloat.split_f64(b)
    zero = torch.zeros_like(xh)
    plan = twofloat.build_kron_df_plan(tdf, npts, (p,) * 3)
    assert plan.runtime == (p > 3)
    per_run = len(RT_PASSES) if plan.runtime else 1
    for given, explicit, negate in (((bh, bl, xh, xl), (bh, bl, xh, xl),
                                     False),
                                    ((None, None, xh, None),
                                     (zero, zero, xh, zero), True)):
        before = twofloat.residual_kron_df.launches
        got = twofloat.residual_kron_df(tdf, *given, (p,) * 3, plan=plan,
                                        negate=negate)
        torch.cuda.synchronize()
        assert twofloat.residual_kron_df.launches - before \
            == per_run * len(plan.chunks) == per_run * 3
        want = twofloat.residual_kron_df_plain(tdf, *explicit, (p,) * 3,
                                               negate=negate)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_degree_6_dw_pcg_on_card_matches_cpu(dev):
    """3D Poisson at degree 6, 16^3 elements, 2 levels (K1r and K5r at
    half-width 6): the card takes the CPU port's iterations with the same
    λs, solutions within 1e-6 of max|x|."""
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    runs, lams = {}, None
    for d in (dev, torch.device("cpu")):
        pcg = MGPreconditionedCG(
            poisson_problem(3, 16, degree=6, device=d, operator="kron"), 2,
            cfg, mixed=True, operator="kron", precision="dw")
        assert pcg._plan_df.P == 6
        pcg.lams = lams = lams or pcg.lams
        runs[d.type] = pcg.solve(tol=1e-10, maxiter=200)
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.converged and gpu.iterations == cpu.iterations
    xg, xc = gpu.x.interior.cpu(), cpu.x.interior
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-6


def test_k5_eft_entry_is_exact(dev):
    g = torch.Generator().manual_seed(1)
    a64 = torch.randn(1 << 16, generator=g, dtype=torch.float64).to(dev)
    b64 = (torch.randn(1 << 16, generator=g, dtype=torch.float64)
           * 1e-3).to(dev)
    (ah, al), (bh, bl) = twofloat.split_f64(a64), twofloat.split_f64(b64)
    out = twofloat.eft_on_card(ah, al, bh, bl)
    refs = [*twofloat.two_sum(ah, bh), *twofloat.two_prod(ah, bh),
            *twofloat.dw_mul(ah, al, bh, bl),
            *twofloat.dw_add(ah, al, bh, bl)]
    for o, r in zip(out, refs):
        assert torch.equal(o, r)
    assert torch.equal(out[2].double() + out[3].double(),
                       ah.double() * bh.double())


@pytest.mark.parametrize("dim,n_el,levels", [(1, 64, 3), (2, 32, 3)])
def test_kron_solve_1d_2d_on_card(dev, dim, n_el, levels):
    """1D and 2D Kronecker-sum problems solve on the card (lifted to 3D by
    K1's wrapper) as they do on the CPU."""
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    runs, lams = {}, None
    for d in (dev, torch.device("cpu")):
        pcg = MGPreconditionedCG(
            poisson_problem(dim, n_el, degree=3, device=d, operator="kron"),
            levels, cfg, operator="kron", precision="dw")
        pcg.lams = lams = lams or pcg.lams
        before = dict(kron_mode.launches)
        runs[d.type] = pcg.solve(tol=1e-10, maxiter=40)
        if d.type == "cuda":
            assert kron_mode.launches["cheb"] > before["cheb"]
            assert kron_mode.launches["apply"] == before["apply"]
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.converged and abs(gpu.iterations - cpu.iterations) <= 1
    xg, xc = gpu.x.interior.cpu(), cpu.x.interior
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-6


def test_dw_pcg_on_card_matches_cpu(dev):
    """The slice at 19³ on the card and on the CPU, with the same λs:
    same iteration count, solutions within 1e-6 of max|x|."""
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    runs = {}
    lams = None
    for d in (dev, torch.device("cpu")):
        pcg = MGPreconditionedCG(
            poisson_problem(3, 16, degree=3, device=d, operator="kron"), 2,
            cfg, operator="kron", precision="dw")
        pcg.lams = lams = lams or pcg.lams
        before = dict(kron_mode.launches)
        k5 = twofloat.residual_kron_df.launches
        runs[d.type] = pcg.solve(tol=1e-10, maxiter=30)
        if d.type == "cuda":
            assert kron_mode.launches["cheb"] > before["cheb"]
            assert kron_mode.launches["residual"] > before["residual"]
            assert twofloat.residual_kron_df.launches > k5
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.converged and gpu.iterations == cpu.iterations
    xg, xc = gpu.x.interior.cpu(), cpu.x.interior
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-6


# -- K2: the banded stencil apply -------------------------------------------

K2_SHAPES = [((1000,), (3,), (False,), (0,)),
             ((37, 45), (2, 3), (False, False), (1, 0)),
             ((16, 20), (3, 3), (True, False), (0, 1)),
             ((17, 19, 23), (3, 3, 3), (False,) * 3, (0, 0, 0)),
             ((9, 13, 70), (1, 2, 1), (False,) * 3, (1, 2, 0)),
             ((33, 33, 33), (3, 3, 3), (False,) * 3, (0, 1, 0))]
K2_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _k2_operands(npts, pads, periodic, dtype, dev, seed=0):
    """Random band, a ghosted x (zeros or the periodic wrap) and b, from
    numpy; diagonal planes shifted to keep Jacobi/GS divisions tame."""
    rng = np.random.default_rng(seed)
    win = tuple(2 * p + 1 for p in pads)
    band = rng.standard_normal(win + tuple(npts)) / 8
    band[pads] += 4.0
    x = torch.as_tensor(rng.standard_normal(npts), dtype=dtype)
    x_pad = ghost_pad(x, pads, periodic)
    b = torch.as_tensor(rng.standard_normal(npts), dtype=dtype)
    return (torch.as_tensor(band, dtype=dtype).to(dev), x_pad.to(dev),
            b.to(dev))


@pytest.mark.parametrize("npts,pads,periodic,starts", K2_SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_kernel_matches_plain(dev, npts, pads, periodic, starts, mode,
                                 dtype):
    """max|Δ|/max|y| ≤ 1e-5 (f32), 1e-12 (f64): the kernel sums in the
    plain version's offset order but contracts into FMAs, and its RB-GS
    forms the off-diagonal sum as Ax − diag·x; points of the other colour
    are copied bit for bit."""
    band, x_pad, b = _k2_operands(npts, pads, periodic, dtype, dev,
                                  seed=sum(npts))
    kw = dict(b=None if mode == "spmv" else b,
              omega=0.8 if mode in ("jacobi", "rbgs") else None,
              color=1, starts=starts)
    before = stencil_apply.launches[mode]
    y = stencil_apply(mode, band, x_pad, npts, pads, **kw)
    torch.cuda.synchronize()
    assert stencil_apply.launches[mode] == before + 1
    want = stencil_apply_plain(mode, band, x_pad, npts, pads, **kw)
    assert float((y - want).abs().max() / want.abs().max()) <= K2_TOL[dtype]
    if mode == "rbgs":
        x_int = x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]
        other = ~color_mask(npts, 1, starts, device=dev)
        assert torch.equal(y[other], x_int[other])


def test_k2_int64_offsets(dev):
    """129³ p3 f32: the band is 2.95 GB, past 2³¹ bytes."""
    npts, pads = (129,) * 3, (3,) * 3
    g = torch.Generator(device=dev).manual_seed(1)
    band = torch.randn((7,) * 3 + npts, generator=g, device=dev)
    x_pad = torch.randn((135,) * 3, generator=g, device=dev)
    assert band.numel() * band.element_size() > 2 ** 31
    y = stencil_apply("spmv", band, x_pad, npts, pads)
    want = stencil_apply_plain("spmv", band, x_pad, npts, pads)
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


def test_k2_failed_launch_raises(dev):
    """p = 20: the halo window needs more shared memory than a block may
    have, so the launch is refused and the wrapper raises."""
    npts, pads = (2, 2, 2), (20, 20, 20)
    band = torch.zeros((41,) * 3 + npts, device=dev)
    x_pad = torch.zeros((42,) * 3, device=dev)
    before = stencil_apply.launches["spmv"]
    with pytest.raises(RuntimeError):
        stencil_apply("spmv", band, x_pad, npts, pads)
    assert stencil_apply.launches["spmv"] == before
    with pytest.raises(TypeError):
        stencil_apply("spmv", band.half(), x_pad.half(), npts, pads)


@pytest.mark.parametrize("contiguous", [False, True])
def test_k4_kernel_matches_torch_sum(dev, contiguous):
    band = make_band(32, 2, contiguous, dev, seed=3)
    x = torch.randn((32,) * 3, device=dev)
    before = stream_probe.launches
    y = stream_probe(band, x, contiguous)
    torch.cuda.synchronize()
    assert stream_probe.launches == before + 1
    want = stream_probe_plain(band, x, contiguous)
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


def test_banded_pcg_on_card_matches_cpu(dev):
    """The banded f64-mixed PCG at 19³ on the card and on the CPU, with the
    card's λs on both: same iterations, solutions within 1e-6 of max|x|."""
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    runs, lams = {}, None
    for d in (dev, torch.device("cpu")):
        pcg = MGPreconditionedCG(poisson_problem(3, 16, degree=3, device=d),
                                 2, cfg, precision="f64")
        pcg.lams = lams = lams or pcg.lams
        before = dict(stencil_apply.launches)
        runs[d.type] = pcg.solve(tol=1e-10, maxiter=30)
        if d.type == "cuda":
            for mode in ("spmv", "residual"):
                assert stencil_apply.launches[mode] > before[mode]
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.converged and gpu.iterations == cpu.iterations
    xg, xc = gpu.x.interior.cpu(), cpu.x.interior
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-6


# -- K3: the v2 engine -------------------------------------------------------

@pytest.mark.parametrize("npts,pads,periodic,starts", K2_SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_kernel_matches_plain(dev, npts, pads, periodic, starts, mode,
                                 dtype):
    """K2's tolerances: K3 sums each point's terms in the plain version's
    offset order, with FMAs; other-colour RB-GS points bit for bit."""
    band, x_pad, b = _k2_operands(npts, pads, periodic, dtype, dev,
                                  seed=sum(npts) + 1)
    packed = pack_band_v2(band, npts, pads)
    kw = dict(b=None if mode == "spmv" else b,
              omega=0.8 if mode in ("jacobi", "rbgs") else None,
              color=0, starts=starts)
    before = stencil_apply_v2.launches[mode]
    y = stencil_apply_v2(mode, band, x_pad, npts, pads, packed=packed, **kw)
    torch.cuda.synchronize()
    assert stencil_apply_v2.launches[mode] == before + 1
    want = stencil_apply_v2_plain(mode, packed, x_pad, npts, pads, **kw)
    assert float((y - want).abs().max() / want.abs().max()) <= K2_TOL[dtype]
    if mode == "rbgs":
        x_int = x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]
        other = ~color_mask(npts, 0, starts, device=dev)
        assert torch.equal(y[other], x_int[other])


def test_k3_failed_launch_raises(dev):
    """p = 20: the band ring needs more shared memory than a block may
    have; the launch is refused, the wrapper raises, the next launch runs."""
    npts, pads = (2, 2, 2), (20, 20, 20)
    band = torch.zeros((41,) * 3 + npts, device=dev)
    x_pad = torch.zeros((42,) * 3, device=dev)
    before = stencil_apply_v2.launches["spmv"]
    with pytest.raises(RuntimeError):
        stencil_apply_v2("spmv", band, x_pad, npts, pads)
    assert stencil_apply_v2.launches["spmv"] == before
    band, x_pad, _ = _k2_operands((9, 13, 70), (1, 2, 1), (False,) * 3,
                                  torch.float32, dev)
    y = stencil_apply_v2("spmv", band, x_pad, (9, 13, 70), (1, 2, 1))
    want = stencil_apply_plain("spmv", band, x_pad, (9, 13, 70), (1, 2, 1))
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


def test_v2_banded_pcg_on_card_matches_k2(dev, monkeypatch):
    """The banded PCG at 19³ under POMS_TPU_SPMV=v2 launches K3 and never
    K2, and takes the K2 run's iterations and solution."""
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    runs, lams = {}, None
    for engine in ("v1", "v2"):
        monkeypatch.setenv("POMS_TPU_SPMV", engine)
        pcg = MGPreconditionedCG(poisson_problem(3, 16, degree=3,
                                                 device=dev), 2, cfg)
        pcg.lams = lams = lams or pcg.lams
        k2, k3 = dict(stencil_apply.launches), dict(stencil_apply_v2.launches)
        runs[engine] = pcg.solve(tol=1e-10, maxiter=30)
        if engine == "v2":
            assert stencil_apply.launches == k2
            assert stencil_apply_v2.launches["residual"] > k3["residual"]
    assert runs["v2"].converged
    assert runs["v2"].iterations == runs["v1"].iterations
    x2, x3 = runs["v1"].x.interior, runs["v2"].x.interior
    assert float((x3 - x2).abs().max() / x2.abs().max()) <= 1e-9


# -- K4c, K4v, K4a: the probes ----------------------------------------------

@pytest.mark.parametrize("n,p", [(32, 3), (40, 2)])
@pytest.mark.parametrize("variant", kp.PROBE_VARIANTS + ("v15",))
def test_probe_kernels_match_plain(dev, n, p, variant):
    band, x_pad = kp.probe_operands(n, p, dev, seed=n + p)
    args = (band, x_pad, (n,) * 3, (p,) * 3)
    if variant == "v15":
        before = kp.v15_apply.launches
        y = kp.v15_apply(*args)
        torch.cuda.synchronize()
        assert kp.v15_apply.launches == before + 1
        want = stencil_apply_plain("spmv", *args)
    else:
        before = kp.stencil_probe.launches[variant]
        y = kp.stencil_probe(variant, *args)
        torch.cuda.synchronize()
        assert kp.stencil_probe.launches[variant] == before + 1
        want = kp.stencil_probe_plain(variant, *args)
    assert float((y - want).abs().max() / want.abs().max()) <= 1e-5


# -- K6, K7, K5's sign operand and the graph-replayed solves ------------------

@pytest.mark.parametrize("negate", [False, True])
def test_k5_negate_on_card(dev, negate):
    terms, (x, b, _) = _mode_operands((17, 33, 65), (3, 3, 3), torch.float64,
                                      dev, 0, seed=3)
    split = {id(B): twofloat.split_f64(B) for t in terms for B in t}
    tdf = [[split[id(B)] for B in t] for t in terms]
    xh, _ = twofloat.split_f64(x)
    zero = torch.zeros_like(xh)
    got = twofloat.residual_kron_df(tdf, None, None, xh, None, (3, 3, 3),
                                    negate=negate)
    want = twofloat.residual_kron_df_plain(tdf, zero, zero, xh, zero,
                                           (3, 3, 3), negate=negate)
    plain = twofloat.residual_kron_df_plain(tdf, zero, zero, xh, zero,
                                            (3, 3, 3))
    sign = -1.0 if negate else 1.0
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, sign * p)


@pytest.mark.parametrize("n", [1, 7, 4913, 2 ** 20 + 1, 129 ** 3])
def test_k6r_matches_the_plain_tree(dev, n):
    """|Δ| ≤ 1e-13·Σ|terms| (another order of double-word additions), two
    runs bit-equal, the result an f64 tensor on the card."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
    y = (torch.randn(n, generator=g, dtype=torch.float64) * 1e-3).to(dev)
    (xh, xl), (yh, yl) = twofloat.split_f64(x), twofloat.split_f64(y)
    pairs = [(xh, xl, yh, yl), (xh, None, yh, yl), (yh, yl, yh, yl),
             (xh, xl, xh, None), (yh, None, xh, None)]
    before = twofloat.dw_dot_stack.launches
    got = twofloat.dw_dot_stack(pairs)
    assert twofloat.dw_dot_stack.launches == before + 2    # 4 dots a pass
    assert got.device == dev and got.dtype == torch.float64
    assert torch.equal(got, twofloat.dw_dot_stack(pairs))
    want = twofloat.dw_dot_stack_plain(pairs)
    scale = torch.stack([(a.double() * c.double()).abs().sum()
                         for a, _, c, _ in pairs])
    assert bool(((got - want).abs() <= 1e-13 * scale).all())
    assert got[0] == twofloat.dw_dot(xh, xl, yh, yl)
    nrm = twofloat.dw_norm2(xh, xl)
    assert nrm.shape == () and nrm == torch.sqrt(
        twofloat.dw_dot(xh, xl, xh, xl))
    assert abs(float(nrm) - float(x.norm())) <= 1e-13 * float(x.norm())
    s = twofloat.dw_sum_tree(xh, xl)
    assert abs(float(s) - float(twofloat.dw_sum_tree_plain(xh, xl))) \
        <= 1e-13 * float(x.abs().sum())


def test_k6r_refuses_what_it_lacks(dev):
    x = torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        twofloat.dw_dot(x.double(), None, x, None)
    with pytest.raises(ValueError):
        twofloat.dw_dot(x, None, x[:4], None)
    with pytest.raises(ValueError):
        twofloat.dw_dot_stack([(x, None, None, x)])


@pytest.mark.parametrize("n", [5, 4913, 129 ** 3])
def test_k6u_is_bit_equal_to_plain(dev, n):
    g = torch.Generator().manual_seed(n)
    f = [torch.randn(n, generator=g).to(dev) for _ in range(7)]
    for k in (1, 3, 6):
        f[k] *= 1e-8
    s0 = torch.tensor(0.37, dtype=torch.float64, device=dev)
    s1 = torch.tensor(-1.91, dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    cases = [("cg", (*f, s0, s1)), ("direction", (f[0], f[2], s0, s1)),
             ("defect", (f[0], f[1], f[2], s0)),
             ("dwrr", (f[0], f[1], f[2], f[4], f[5], s0, s1)),
             ("dwrr", (f[0], f[1], f[2], None, None, s0, s1)),
             ("div", (f[0], s0)), ("mul", (f[0], s0)), ("div", (f[0], zero)),
             ("mul", (f[0], s1))]          # s1 < 0: safe() gives 1
    for mode, ops in cases:
        before = twofloat.dw_update.launches
        got = twofloat.dw_update(mode, *ops)
        assert twofloat.dw_update.launches == before + 1
        want = twofloat.dw_update_plain(mode, *ops)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), mode
    shaped = twofloat.dw_update("mul", f[0].reshape(1, n), s0)
    assert shaped.shape == (1, n)
    with pytest.raises(TypeError):
        twofloat.dw_update("mul", f[0], s0.float())
    with pytest.raises(ValueError):
        twofloat.dw_update("dwrr", f[0], f[1], f[2], f[3], None, s0, s1)


def _k7_case(kind, n_el):
    """The 1D prolongation of a level pair: open-knot (the Poisson
    hierarchies) or periodic (wrapped rows)."""
    if kind == "periodic":
        return prolongation_periodic_1d(n_el // 2, 3)
    return prolongation_interior_1d(n_el // 2, 3)


# every level pair of the 128^3 hierarchies (open-knot and periodic), the
# 2D 513^2 <-> 257^2 pair and a 1D one
K7_CASES = [(kind, n_el, 3) for kind in ("open", "periodic")
            for n_el in (128, 64, 32, 16)] + [("open", 512, 2),
                                              ("open", 64, 1)]


@pytest.mark.parametrize("kind,n_el,d", K7_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_is_bit_equal_to_plain(dev, kind, n_el, d, dtype):
    """One launch per transfer, every axis in it; the bits of the plain
    gathers (periodic: wrapped bands of p + 2 and 2 taps, and the bits of
    the W = n_in evaluation, up to the sign of a zero)."""
    P = _k7_case(kind, n_el)
    nf, nc = P.shape
    pro = tuple(k7.bands_from_dense(P, dtype, dev) for _ in range(d))
    res = tuple(k7.bands_from_dense(P.T, dtype, dev) for _ in range(d))
    assert res[0].wrap == pro[0].wrap == (kind == "periodic")
    g = torch.Generator().manual_seed(n_el)
    xf = torch.randn((nf,) * d, generator=g,
                     dtype=torch.float64).to(dev).to(dtype)
    xc = torch.randn((nc,) * d, generator=g,
                     dtype=torch.float64).to(dev).to(dtype)
    before = k7.apply_transfer.launches
    got = k7.apply_transfer(res, xf)
    assert k7.apply_transfer.launches == before + 1
    assert torch.equal(got, k7.apply_transfer_plain(res, xf))
    up = k7.apply_transfer(pro, xc, add=xf)
    assert k7.apply_transfer.launches == before + 2
    assert torch.equal(up, k7.apply_transfer_plain(pro, xc, add=xf))
    if kind == "periodic":      # the JAX package's W = n_in bands
        full = [k7.TransferBand(w=torch.as_tensor(M, dtype=dtype, device=dev),
                                c0=torch.zeros(M.shape[0], dtype=torch.int64,
                                               device=dev), n_in=M.shape[1])
                for M in (P.T, P)]
        assert torch.equal(got + 0.0, k7.apply_transfer_plain(
            (full[0],) * d, xf) + 0.0)
        assert torch.equal(up + 0.0, k7.apply_transfer_plain(
            (full[1],) * d, xc, add=xf) + 0.0)
    # a strided view is made contiguous by the wrapper
    pad = torch.zeros((nf + 2,) * d, dtype=dtype, device=dev)
    inner = pad[(slice(1, nf + 1),) * d]
    inner.copy_(xf)
    assert torch.equal(k7.apply_transfer(res, inner), got)
    with pytest.raises(ValueError):
        k7.apply_transfer(res, xc)
    with pytest.raises(TypeError):
        k7.apply_transfer(res, xf.half())
    with pytest.raises(ValueError):      # weights and field of one dtype
        k7.apply_transfer(res, xf.to(torch.bfloat16))


def _cheb_cfg(fraction=16.0):
    return CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=fraction))


@pytest.mark.parametrize("solver", ["dw", "dwrr", "f64", "twofloat",
                                    "mixed-f64", "mg", "dw-bf16",
                                    "twofloat-bf16", "mixed-f64-bf16",
                                    "dwrr-bf16", "periodic-dw",
                                    "periodic-twofloat"])
def test_graph_replay_equals_the_eager_loop(dev, solver):
    """solve_compiled replays a captured graph: the eager loop's iterates
    bit for bit, the same count; the graph is captured once per solver and
    reused by the second call; replays advance the launch counters.  The
    bf16 cycles' casts and the periodic operators capture like the rest."""
    low = torch.bfloat16 if solver.endswith("-bf16") else torch.float32
    periodic = solver.startswith("periodic-")
    solver = solver.replace("-bf16", "").replace("periodic-", "")
    if periodic:
        prob = periodic_problem(3, 32, degree=3, device=dev)
    else:
        prob = poisson_problem(3, 32, degree=3, device=dev, operator="kron")
    if solver in ("dw", "dwrr", "f64"):
        sol = MGPreconditionedCG(prob, 3 - periodic, _cheb_cfg(),
                                 operator="kron", precision=solver,
                                 low_dtype=low)
    elif solver == "mg":
        sol = MultigridSolver(prob, 3, _cheb_cfg(), operator="kron")
    else:
        sol = MixedPrecisionMG(prob, 3 - periodic, _cheb_cfg(),
                               operator="kron", low_dtype=low,
                               residual=solver.replace("mixed-", ""))
    # the eager loop: the steps solve_compiled would run without a graph
    if solver == "mg":
        res = sol.solve(tol=1e-10, maxiter=60)
        want_x, want_rn, want_it = (res.x.interior, res.residuals[-1],
                                    res.iterations)
    else:
        start = sol._start(prob.b)
        state, consts, step, rn = start[:4]
        per = start[4] if len(start) > 4 else 1
        want_it = 0
        while float(rn) > 1e-10 and want_it < 60:
            *state, rn = step(*state, *consts)
            want_it += per
        want_x, want_rn = sol._x_interior(state), float(rn)
    assert sol._graphs == {}
    x, rn, it = sol.solve_compiled(tol=1e-10, maxiter=60)
    assert it == want_it and float(rn) == want_rn
    assert torch.equal(x.interior, want_x)
    (graph,) = sol._graphs.values()
    assert graph.replays == it // (3 if solver == "dwrr" else 1)
    before = counters.snapshot()
    x2, rn2, it2 = sol.solve_compiled(tol=1e-10, maxiter=60)
    assert list(sol._graphs.values()) == [graph]          # reused
    assert it2 == it and torch.equal(x2.interior, x.interior)
    grown = counters.diff(counters.snapshot(), before)
    assert grown["kron_mode.cheb"] >= graph.captured["kron_mode.cheb"] \
        * graph.replays // 2
    assert grown["transfer"] > 0
    if low == torch.bfloat16:     # the cycle's kernels are the bf16 ones
        assert grown["kron_mode.cheb@bf16"] == grown["kron_mode.cheb"]
        assert grown["transfer@bf16"] == grown["transfer"]
    sol.lams = sol.lams                                   # drops the graphs
    assert sol._graphs == {}


def test_defect_correction_on_card_matches_cpu(dev):
    """16³ p3, 2 levels, the card's λs on both: equal counts, solutions
    within 1e-6 of max|x| (K6r sums in another order than the CPU tree)."""
    out, lams = {}, None
    for d in (dev, torch.device("cpu")):
        prob = poisson_problem(3, 16, degree=3, device=d, operator="kron")
        mg = MixedPrecisionMG(prob, 2, _cheb_cfg(), operator="kron")
        mg.lams = lams = lams or mg.lams
        out[d.type] = mg.solve(tol=5e-9, maxiter=60)
    rc, rh = out["cuda"], out["cpu"]
    assert rc.converged and rh.converged
    assert rc.iterations == rh.iterations
    xc, xh = rc.x.interior.cpu(), rh.x.interior
    assert float((xc - xh).abs().max() / xh.abs().max()) <= 1e-6


def test_device_ms_clocks_agree(dev):
    """The profiler's device time, the replayed graph's event time and the
    stream's event time of one 129³ f32 add: the graph within 3 µs + 30% of
    the profiler, the stream no lower than 0.7 of it."""
    from poms_tpu_torch.bench import device
    a = torch.randn(129 ** 3, device=dev)
    out = torch.empty_like(a)
    fn = lambda: torch.add(a, a, out=out)
    fn()
    prof = device.profiler_ms(fn)
    graph, stream = device.graph_event_ms(fn), device.stream_event_ms(fn)
    assert prof is not None and prof > 0
    assert abs(graph - prof) <= 3e-3 + 0.3 * prof
    assert stream >= 0.7 * prof


def test_device_ms_without_the_profiler(dev, monkeypatch, capsys):
    """With a profiler that records nothing, device_ms times by events:
    around a graph, or around the calls where one synchronises (and the
    card still works after the refused capture)."""
    from poms_tpu_torch.bench import device
    monkeypatch.setattr(device, "profiler_ms", lambda *a, **k: None)
    a = torch.randn(129 ** 3, device=dev)
    out = torch.empty_like(a)
    ms = device.device_ms(lambda: torch.add(a, a, out=out))
    assert 0 < ms < 1.0
    assert "replayed graph" in capsys.readouterr().err
    ms = device.device_ms(lambda: float(a.sum()), 3)
    assert 0 < ms < 5.0
    assert "no graph" in capsys.readouterr().err
    assert torch.equal(torch.add(a, a), out)


# -- bf16 instantiations, K5's four histories, periodic problems -------------

BF16 = torch.bfloat16


def _bf16_differing(got, want):
    """Both bf16, from f32 sums taken in another order: every value within
    one bf16 unit in the last place (2⁻⁷ of its magnitude) plus the f32
    sums' own error (1e-5 of max|want|); returns how many points differ."""
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5 * w.abs().max()
    assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())
    return int((g != w).sum())


# ragged tiles and odd row lengths (2-byte alignment), 1D-3D, wrapped ghosts
BF16_K2_SHAPES = [((17, 33, 65), (3, 3, 3), (False,) * 3),
                  ((5, 7, 9), (3, 2, 1), (False, True, False)),
                  ((20, 45, 71), (1, 2, 3), (False,) * 3),
                  ((33, 131), (2, 2), (True, False)),
                  ((1001,), (3,), (False,)), ((7,), (1,), (True,))]


@pytest.mark.parametrize("npts,pads,periodic", BF16_K2_SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["K2", "K3"])
def test_banded_bf16_kernels_match_plain(dev, npts, pads, periodic, mode,
                                         engine):
    band, x_pad, b = _k2_operands(npts, pads, periodic, torch.float32, dev,
                                  seed=sum(npts))
    band, x_pad, b = band.to(BF16), x_pad.to(BF16).contiguous(), b.to(BF16)
    kw = dict(b=None if mode == "spmv" else b,
              omega=0.8 if mode in ("jacobi", "rbgs") else None, color=1,
              starts=(1,) + (0,) * (len(npts) - 1))
    wrapper = stencil_apply if engine == "K2" else stencil_apply_v2
    before = wrapper.launches_by_dtype["bf16"][mode]
    if engine == "K2":
        got = stencil_apply(mode, band, x_pad, npts, pads, **kw)
        want = stencil_apply_plain(mode, band, x_pad, npts, pads, **kw)
    else:
        pk = pack_band_v2(band, npts, pads)
        assert pk["blk"].dtype == BF16 and pk["blk"].data_ptr() % 16 == 0
        got = stencil_apply_v2(mode, None, x_pad, npts, pads, packed=pk, **kw)
        want = stencil_apply_v2_plain(mode, pk, x_pad, npts, pads, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches_by_dtype["bf16"][mode] == before + 1
    assert got.dtype == BF16 and got.shape == want.shape
    assert _bf16_differing(got, want) <= max(2, got.numel() // 50)
    if mode == "rbgs":
        other = ~color_mask(npts, 1, kw["starts"], device=dev)
        x_int = x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]
        assert torch.equal(got[other], x_int[other])


# wide bands on 3D grids: K2 cuts its rows into shorter runs (129 at p = 8
# in f64, 256 at p = 7), K3 takes a smaller tile (2 x 8 x 32 in f32 from
# p = 7, 1 x 8 x 32 and 1 x 4 x 32 in f64 from p = 6)
WIDE_BANDS = [((9, 12, 129), 8), ((8, 8, 256), 7), ((6, 9, 40), 8),
              ((5, 7, 33), 6)]


@pytest.mark.parametrize("npts,p", WIDE_BANDS)
@pytest.mark.parametrize("engine", ["K2", "K3"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_wide_bands_match_plain(dev, npts, p, engine, dtype, tol):
    """Every mode at p = 6-8 on 3D grids whose default block would not fit
    a block's shared memory: within K2's tolerances of the plain version,
    RB-GS leaving the other colour as it was."""
    pads = (p,) * 3
    band, x_pad, b = _k2_operands(npts, pads, (False,) * 3, dtype, dev,
                                  seed=p)
    x_int = x_pad[tuple(slice(q, q + n) for n, q in zip(npts, pads))]
    packed = pack_band_v2(band, npts, pads) if engine == "K3" else None
    for mode in MODES:
        kw = dict(b=None if mode == "spmv" else b,
                  omega=0.8 if mode in ("jacobi", "rbgs") else None)
        if engine == "K2":
            got = stencil_apply(mode, band, x_pad, npts, pads, **kw)
        else:
            got = stencil_apply_v2(mode, None, x_pad, npts, pads,
                                   packed=packed, **kw)
        torch.cuda.synchronize()
        want = stencil_apply_plain(mode, band, x_pad, npts, pads, **kw)
        assert float((got - want).abs().max() / want.abs().max()) <= tol
        if mode == "rbgs":
            other = ~color_mask(npts, 0, device=dev)
            assert torch.equal(got[other], x_int[other])


def test_k3_refuses_a_pack_of_another_dtype(dev):
    npts, pads = (8, 12, 20), (1, 1, 1)
    band, x_pad, _ = _k2_operands(npts, pads, (False,) * 3, torch.float32,
                                  dev)
    pk = pack_band_v2(band, npts, pads)
    with pytest.raises(ValueError, match="slabs"):
        stencil_apply_v2("spmv", None, x_pad.to(BF16), npts, pads, packed=pk)
    with pytest.raises(ValueError, match="slabs"):
        stencil_apply_v2("spmv", None, x_pad, npts, pads,
                         packed=pack_band_v2(band.to(BF16), npts, pads))


BF16_K1_SHAPES = [((17, 17, 17), (3, 3, 3), (False,) * 3, 0),
                  ((9, 13, 31), (2, 2, 2), (False,) * 3, 0),
                  ((12, 20, 41), (2, 3, 1), (True, False, True), 0),
                  ((30, 257), (3, 3), (False, False), 0),
                  ((4099,), (3,), (True,), 0),
                  ((20, 21, 23), (2, 2, 2), (False,) * 3, 4),
                  # degrees 4-8: K1r
                  ((14, 19, 40), (5, 5, 5), (False,) * 3, 0),
                  ((13, 16, 33), (4, 4, 4), (True,) * 3, 0),
                  ((18, 20, 41), (8, 8, 8), (False,) * 3, 0),
                  ((40, 67), (7, 7), (False, True), 0),
                  ((20, 21, 40), (8, 8, 8), (False,) * 3, 4)]


@pytest.mark.parametrize("npts,pads,periodic,free", BF16_K1_SHAPES)
@pytest.mark.parametrize("mode", K1_MODES + ("cheb0",))
def test_k1_bf16_modes_match_plain(dev, npts, pads, periodic, free, mode):
    """K1's bf16 instantiation (the compiled kernel at half-widths 1-3 at
    both micro-tile heights, K1r above them) against its plain version
    (f32 arithmetic, one rounding), odd row lengths and a two-run operator
    (whose sum between the runs stays f32) among the shapes."""
    terms, (x, b, d) = _mode_operands(npts, pads, torch.float32, dev, free,
                                      seed=sum(npts))
    cast = {}
    terms = [[cast.setdefault(id(B), B.to(BF16)) for B in t] for t in terms]
    x, b, d = x.to(BF16), b.to(BF16), d.to(BF16)
    runtime = max(pads) > 3
    per_run = len(RT_PASSES) if runtime else 1
    kw = {}
    real = mode.replace("0", "")
    if real in ("residual", "cheb"):
        kw["b"] = b
    if real == "cheb":
        kw.update(c1=0.3, c2=0.7, d=None if mode == "cheb0" else d)
    cpu_plan = build_kron_plan([[B.cpu() for B in t] for t in terms], npts,
                               pads, periodic)
    want = kron_mode(real, cpu_plan, x.cpu(), **{
        k: v.cpu() if isinstance(v, torch.Tensor) else v
        for k, v in kw.items()})
    if real != "cheb":
        want = (want,)
    for trows in [None] if runtime else [(R,) for R in rows_options()]:
        plan = build_kron_plan(terms, npts, pads, periodic, trows=trows)
        assert plan.runtime == runtime
        assert trows is None or (plan.trows,) == trows
        kw_k = dict(kw, d=d.clone()) if kw.get("d") is not None else kw
        before = kron_mode.launches_by_dtype["bf16"][real]
        got = kron_mode(real, plan, x, **kw_k)
        torch.cuda.synchronize()
        runs = len(plan.plans)
        assert kron_mode.launches_by_dtype["bf16"][real] - before \
            == per_run * (runs if real == "apply" else 1)
        if real != "cheb":
            got = (got,)
        for g, w in zip(got, want):
            assert g.dtype == BF16
            assert _bf16_differing(g.cpu(), w) <= max(2, g.numel() // 50), \
                trows


def test_k1_bf16_stops_at_half_width_3(dev):
    """bf16 has the compiled half-widths 1-3 and K1r above them (here 5
    and 8); past K1r's widest (218) the plan is refused on the card, naming
    the bytes."""
    for p in (5, 8):
        terms, (x, _, _) = _mode_operands((16, 17, 18), (p,) * 3,
                                          torch.float32, dev, 0)
        terms = [[B.to(BF16) for B in t] for t in terms]
        y = kron_apply(terms, x.to(BF16), (16, 17, 18), (p,) * 3,
                       (False,) * 3)
        assert y.dtype == BF16 and bool(torch.isfinite(y.float()).all())
    terms, (x, _, _) = _mode_operands((4, 5, 6), (219, 219, 219),
                                      torch.float32, dev, 0)
    terms = [[B.to(BF16) for B in t] for t in terms]
    with pytest.raises(RuntimeError, match="bytes of shared memory"):
        kron_apply(terms, x.to(BF16), (4, 5, 6), (219,) * 3, (False,) * 3)


@pytest.mark.parametrize("kind,n_el,d", K7_CASES)
def test_k7_bf16_is_bit_equal_to_plain(dev, kind, n_el, d):
    """The f32 tap sums are taken in the plain version's order with
    uncontracted operations and rounded to bf16 between the axes, as the
    plain version rounds its field, so the bf16 results agree bit for bit;
    one launch per transfer."""
    P = _k7_case(kind, n_el)
    nf, nc = P.shape
    pro = tuple(k7.bands_from_dense(P, BF16, dev) for _ in range(d))
    res = tuple(k7.bands_from_dense(P.T, BF16, dev) for _ in range(d))
    g = torch.Generator().manual_seed(n_el)
    xf = torch.randn((nf,) * d, generator=g).to(dev).to(BF16)
    xc = torch.randn((nc,) * d, generator=g).to(dev).to(BF16)
    before = k7.apply_transfer.launches_by_dtype["bf16"]
    got = k7.apply_transfer(res, xf)
    assert k7.apply_transfer.launches_by_dtype["bf16"] == before + 1
    assert got.dtype == BF16
    assert torch.equal(got, k7.apply_transfer_plain(res, xf))
    assert torch.equal(k7.apply_transfer(pro, xc, add=xf),
                       k7.apply_transfer_plain(pro, xc, add=xf))


def _periodic_df_terms(npts, pads, dev, seed):
    """[S, M, M], [K, M, M], [M, K, M], [M, M, K] with distinct S, K, M per
    axis, split into pairs: 2 u, 3 v, 4 histories, 4 terms."""
    rng = np.random.default_rng(seed)

    def band(n, p):
        B = torch.as_tensor(rng.standard_normal((n, 2 * p + 1)) / 4
                            + 2.0 * (np.arange(2 * p + 1) == p), device=dev)
        return twofloat.split_f64(B)

    Ks = [band(n, p) for n, p in zip(npts, pads)]
    Ms = [band(n, p) for n, p in zip(npts, pads)]
    S = band(npts[0], pads[0])
    return ([[S, Ms[1], Ms[2]]]
            + [[Ks[b] if b == a else Ms[b] for b in range(3)]
               for a in range(3)])


@pytest.mark.parametrize("npts,pads,periodic", [
    ((16, 16, 16), (2, 2, 2), (True,) * 3),
    ((9, 13, 31), (3, 2, 1), (False, True, False)),
    ((33, 33, 33), (3, 3, 3), (True,) * 3)])
@pytest.mark.parametrize("flags", ["full", "zero"])
def test_k5_four_histories_are_bit_equal_to_plain(dev, npts, pads, periodic,
                                                  flags):
    tdf = _periodic_df_terms(npts, pads, dev, seed=sum(npts))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(npts, generator=g, dtype=torch.float64).to(dev)
    b = torch.randn(npts, generator=g, dtype=torch.float64).to(dev)
    (xh, xl), (bh, bl) = twofloat.split_f64(x), twofloat.split_f64(b)
    zero = torch.zeros_like(xh)
    given, explicit = {"full": ((bh, bl, xh, xl), (bh, bl, xh, xl)),
                       "zero": ((None, None, xh, None),
                                (zero, zero, xh, zero))}[flags]
    before = twofloat.residual_kron_df.launches
    got = twofloat.residual_kron_df(tdf, *given, pads, periodic=periodic)
    torch.cuda.synchronize()
    assert twofloat.residual_kron_df.launches == before + 1
    want = twofloat.residual_kron_df_plain(tdf, *explicit, pads, None,
                                           periodic)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


@pytest.mark.parametrize("case", ["twofloat-bf16", "dw-bf16", "banded-bf16",
                                  "periodic-twofloat", "periodic-dw",
                                  "periodic-banded"])
def test_bf16_and_periodic_solves_on_card_match_cpu(dev, case):
    """16³, 2 levels, the card's λs on both: equal counts (bf16: within one,
    since kernel and plain version round a few points differently), the
    solutions within 1e-6 of max|x|."""
    kind, low = case.replace("periodic-", "").replace("-bf16", ""), (
        BF16 if case.endswith("-bf16") else torch.float32)
    out, lams = {}, None
    for d in (dev, torch.device("cpu")):
        op = "banded" if kind == "banded" else "kron"
        if case.startswith("periodic-"):
            prob = periodic_problem(3, 16, degree=2, device=d)
        else:
            prob = poisson_problem(3, 16, degree=2, device=d, operator=op)
        if kind == "dw":
            sol = MGPreconditionedCG(prob, 2, _cheb_cfg(), operator="kron",
                                     precision="dw", low_dtype=low)
        else:
            sol = MixedPrecisionMG(prob, 2, _cheb_cfg(), operator=op,
                                   low_dtype=low)
        sol.lams = lams = lams or sol.lams
        out[d.type] = sol.solve(tol=1e-10, maxiter=60)
    rc, rh = out["cuda"], out["cpu"]
    assert rc.converged and rh.converged
    assert abs(rc.iterations - rh.iterations) <= (low == BF16)
    xc, xh = rc.x.interior.cpu(), rh.x.interior
    assert float((xc - xh).abs().max() / xh.abs().max()) <= 1e-6


# -- K2 at the level shapes, every dtype; K6r in one launch ------------------

@pytest.mark.parametrize("n", [129, 128, 65, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, BF16],
                         ids=["f32", "f64", "bf16"])
def test_k2_level_shapes_match_plain(dev, n, dtype):
    """Every mode, one launch a pass; f32 1e-5 and f64 1e-12 of max|y|,
    bf16 within one unit in the last place plus the f32 sums' 1e-5 (the
    same terms in the same order, contracted into FMAs)."""
    npts, pads = (n,) * 3, (3,) * 3
    g = torch.Generator(device=dev).manual_seed(n)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    band = torch.randn((7,) * 3 + npts, generator=g, dtype=work,
                       device=dev).div_(8)
    band[3, 3, 3] += 4.0
    x = torch.randn(npts, generator=g, dtype=work, device=dev)
    b = torch.randn(npts, generator=g, dtype=work, device=dev)
    band, x, b = band.to(dtype), x.to(dtype), b.to(dtype)
    x_pad = ghost_pad(x, pads, (False,) * 3).contiguous()
    name = {torch.float32: "f32", torch.float64: "f64", BF16: "bf16"}[dtype]
    for mode in MODES:
        kw = dict(b=None if mode == "spmv" else b,
                  omega=0.8 if mode in ("jacobi", "rbgs") else None,
                  color=n % 2, starts=(0, 1, 0))
        before = stencil_apply.launches_by_dtype[name][mode]
        y = stencil_apply(mode, band, x_pad, npts, pads, **kw)
        torch.cuda.synchronize()
        assert stencil_apply.launches_by_dtype[name][mode] == before + 1
        want = stencil_apply_plain(mode, band, x_pad, npts, pads, **kw)
        if dtype == BF16:
            assert _bf16_differing(y, want) <= y.numel() // 50
        else:
            rel = float((y - want).abs().max() / want.abs().max())
            assert rel <= K2_TOL[dtype], (mode, rel)
        if mode == "rbgs":
            other = ~color_mask(npts, n % 2, (0, 1, 0), device=dev)
            assert torch.equal(y[other], x[other])
        del y, want
    del band


def _k6r_fields(n, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
    y = (torch.randn(n, generator=g, dtype=torch.float64) * 1e-3).to(dev)
    z = torch.randn(n, generator=g).to(dev)
    return x, y, z


def test_k6r_one_launch_a_call_and_the_same_bits(dev):
    x, y, z = _k6r_fields(129 ** 3, dev)
    (xh, xl), (yh, yl) = twofloat.split_f64(x), twofloat.split_f64(y)
    pair = [(z, None, xh, xl), (z, None, yh, yl)]
    for call in (lambda: twofloat.dw_dot_stack(pair),
                 lambda: twofloat.dw_norm2(xh, xl),
                 lambda: twofloat.dw_dot(z, None, xh, xl)):
        before = twofloat.dw_dot_stack.launches
        first = call()
        assert twofloat.dw_dot_stack.launches == before + 1
        assert torch.equal(first, call())
    part, counter = twofloat.reduce_scratch(dev)
    assert twofloat.reduce_scratch(dev)[0] is part
    torch.cuda.synchronize()
    assert int(counter) == 0


def test_k6r_graph_replays_give_the_same_bits(dev):
    x, y, z = _k6r_fields(2 ** 20 + 1, dev, seed=1)
    (xh, xl), (yh, yl) = twofloat.split_f64(x), twofloat.split_f64(y)
    pair = [(z, None, xh, xl), (z, None, yh, yl)]
    eager = twofloat.dw_dot_stack(pair)
    nrm = twofloat.dw_norm2(xh, xl)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        twofloat.dw_dot_stack(pair)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = twofloat.dw_dot_stack(pair)
        got_n = twofloat.dw_norm2(xh, xl)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, eager) and torch.equal(got_n, nrm)


def test_k6r_thousand_calls_keep_the_bits(dev):
    """The arrival counter is reset by each call's last block."""
    x, y, z = _k6r_fields(65 ** 3, dev, seed=2)
    (xh, xl), (yh, yl) = twofloat.split_f64(x), twofloat.split_f64(y)
    pair = [(z, None, xh, xl), (z, None, yh, yl)]
    first = twofloat.dw_dot_stack(pair)
    outs = [twofloat.dw_dot_stack(pair) for _ in range(1000)]
    assert all(torch.equal(o, first) for o in outs)


@pytest.mark.parametrize("n", [12345, 2 ** 20 + 1])
def test_k6r_sizes_and_an_unaligned_view(dev, n):
    """Within K6_TOL (1e-13 of Σ|terms|, another order of double-word adds)
    of the plain tree; a view that starts 4 bytes past a 16-byte boundary
    gives the same bits as an aligned copy (the order depends on n alone)."""
    x, y, z = _k6r_fields(n, dev, seed=n)
    (xh, xl), (yh, yl) = twofloat.split_f64(x), twofloat.split_f64(y)
    pairs = [(z, None, xh, xl), (z, None, yh, yl), (xh, xl, xh, xl)]
    got = twofloat.dw_dot_stack(pairs)
    want = twofloat.dw_dot_stack_plain(pairs)
    scale = torch.stack([(a.double() * c.double()).abs().sum()
                         for a, _, c, _ in pairs])
    assert bool(((got - want).abs() <= 1e-13 * scale).all())
    shifted = []
    for t in (z, xh, xl, yh, yl):
        buf = torch.empty(n + 1, dtype=t.dtype, device=dev)
        buf[1:] = t
        view = buf[1:]
        assert view.data_ptr() % 16 != 0
        shifted.append(view)
    zs, xhs, xls, yhs, yls = shifted
    spairs = [(zs, None, xhs, xls), (zs, None, yhs, yls), (xhs, xls, xhs, xls)]
    assert torch.equal(twofloat.dw_dot_stack(spairs), got)
    assert torch.equal(twofloat.dw_norm2(xhs, xls),
                       twofloat.dw_norm2(xh, xl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, BF16],
                         ids=["f32", "f64", "bf16"])
def test_k2_band_view_off_a_granule(dev, dtype):
    """A band that starts 1 element past a 16-byte boundary: the copies
    take the granules around it, the result is the aligned band's bits."""
    npts, pads = (17, 19, 23), (3, 3, 3)
    band, x_pad, b = _k2_operands(npts, pads, (False,) * 3, torch.float64,
                                  dev, seed=5)
    band, x_pad = band.to(dtype), x_pad.to(dtype).contiguous()
    buf = torch.empty(band.numel() + 1, dtype=dtype, device=dev)
    buf[1:] = band.reshape(-1)
    view = buf[1:].view(band.shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    got = stencil_apply("spmv", view, x_pad, npts, pads)
    assert torch.equal(got, stencil_apply("spmv", band, x_pad, npts, pads))


# -- K1r and K5r: the half-width taken at run time (spline degrees 4 and up) --

# npts, pads, periodic, sharing-free terms (0: Poisson-shaped); a periodic
# axis holds its band (n > 2p)
K1R_SHAPES = [((20, 22, 40), (9, 9, 9), (False,) * 3, 0),
              ((23, 26, 31), (9, 9, 9), (True,) * 3, 0),
              ((27, 30, 52), (12, 12, 12), (False,) * 3, 0),
              ((26, 28, 33), (12, 12, 12), (True, False, True), 0),
              ((40, 61), (12, 12), (False, True), 0),
              ((300,), (9,), (True,), 0),
              ((20, 21, 30), (9, 9, 9), (False,) * 3, 4)]


def _k1_case(npts, pads, dtype, dev, free, mode):
    """Operands of one K1 check in ``dtype`` (bf16: cast from f32, one cast
    a distinct band) and the kwargs of ``mode`` (``cheb0``: the first
    Chebyshev step)."""
    work = torch.float32 if dtype == BF16 else dtype
    terms, (x, b, d) = _mode_operands(npts, pads, work, dev, free,
                                      seed=sum(npts) + sum(pads))
    cast = {}
    terms = [[cast.setdefault(id(B), B.to(dtype)) for B in t] for t in terms]
    x, b, d = x.to(dtype), b.to(dtype), d.to(dtype)
    real = mode.replace("0", "")
    kw = {}
    if real in ("residual", "cheb"):
        kw["b"] = b
    if real == "cheb":
        kw.update(c1=0.3, c2=0.7, d=None if mode == "cheb0" else d)
    return terms, x, real, kw


def _on_card(real, plan, x, kw):
    """One K1 pass (``d`` cloned: the kernel updates it in place)."""
    kw = dict(kw)
    if kw.get("d") is not None:
        kw["d"] = kw["d"].clone()
    got = kron_mode(real, plan, x, **kw)
    torch.cuda.synchronize()
    return got if real == "cheb" else (got,)


@pytest.mark.parametrize("npts,pads,periodic,free", K1R_SHAPES)
@pytest.mark.parametrize("mode", K1_MODES + ("cheb0",))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, BF16],
                         ids=["f32", "f64", "bf16"])
def test_k1r_modes_match_plain(dev, npts, pads, periodic, free, mode, dtype):
    """K1r in every mode and dtype at half-widths 9 and 12, periodic or
    not, 1D-3D and a two-launch operator: within the compiled K1's
    tolerances of the plain version (max|Δ|/max|y| ≤ 1e-5 in f32, 1e-12 in
    f64; bf16 one unit in the last place plus the f32 sums' error); three
    launches (passes A, B, C) a run of terms."""
    terms, x, real, kw = _k1_case(npts, pads, dtype, dev, free, mode)
    plan = build_kron_plan(terms, npts, pads, periodic)
    assert plan.runtime and plan.P == max(pads) and plan.tcols == 1
    cpu_plan = build_kron_plan([[B.cpu() for B in t] for t in terms], npts,
                               pads, periodic)
    want = kron_mode(real, cpu_plan, x.cpu(), **{
        k: v.cpu() if isinstance(v, torch.Tensor) else v
        for k, v in kw.items()})
    before = sum(kron_mode.runtime.launches.values())
    got = _on_card(real, plan, x, kw)
    assert sum(kron_mode.runtime.launches.values()) - before \
        == 3 * len(plan.plans)
    if real != "cheb":
        want = (want,)
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == BF16:
            assert _bf16_differing(g, w) <= max(2, g.numel() // 50)
        else:
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert float((g - w).abs().max() / w.abs().max()) <= tol


def _k5_terms(npts, pads, dev, four, free=0):
    """Double-word terms: Poisson-shaped (3 histories), the periodic
    shifted shape (4) or ``free`` sharing-free terms."""
    if four:
        return _periodic_df_terms(npts, pads, dev, seed=sum(npts))
    terms, _ = _mode_operands(npts, pads, torch.float64, dev, free,
                              seed=sum(npts))
    split = {id(B): twofloat.split_f64(B) for t in terms for B in t}
    return [[split[id(B)] for B in t] for t in terms]


K5R_SHAPES = [((20, 22, 40), (9, 9, 9), (False,) * 3, False),
              ((23, 26, 31), (9, 9, 9), (True,) * 3, True),
              ((27, 28, 52), (12, 12, 12), (False,) * 3, False),
              ((26, 28, 33), (12, 12, 12), (True, False, True), True),
              ((36, 37, 40), (16, 16, 16), (False,) * 3, False),
              ((34, 35, 40), (16, 16, 16), (True,) * 3, True),
              ((40, 61), (12, 12), (False, True), False),
              # degrees 4 and 6-8 (the shapes K5 took when it was compiled
              # there)
              ((20, 22, 40), (8, 8, 8), (False,) * 3, False),
              ((19, 21, 34), (6, 6, 6), (False,) * 3, False),
              ((23, 18, 40), (7, 7, 7), (True,) * 3, False),
              ((40, 41), (8, 8), (False, False), False),
              ((18, 20, 36), (8, 8, 8), (True,) * 3, True),
              ((14, 13, 30), (4, 4, 4), (False,) * 3, True),
              ((11, 12, 25), (4, 4, 4), (False,) * 3, False),
              ((16, 17, 30), (6, 6, 6), (True,) * 3, True),
              ((15, 18, 32), (7, 7, 7), (False,) * 3, True)]


@pytest.mark.parametrize("npts,pads,periodic,four", K5R_SHAPES)
@pytest.mark.parametrize("negate", [False, True])
def test_k5r_is_bit_equal_to_plain(dev, npts, pads, periodic, four, negate):
    """K5r at half-widths 4, 6-9, 12 and 16 with 3 and 4 histories: the words
    equal the plain version's, b and x_l given and as A.p (the zero
    flags), negated or not, three launches (passes A, B, C) a call;
    registers within the limit."""
    tdf = _k5_terms(npts, pads, dev, four)
    rng = np.random.default_rng(len(npts))
    (xh, xl), (bh, bl) = (twofloat.split_f64(torch.as_tensor(
        rng.standard_normal(npts), device=dev)) for _ in range(2))
    zero = torch.zeros_like(xh)
    plan = twofloat.build_kron_df_plan(tdf, npts, pads, periodic)
    assert plan.runtime and plan.P == max(pads)
    for given, explicit in (((bh, bl, xh, xl), (bh, bl, xh, xl)),
                            ((None, None, xh, None), (zero, zero, xh, zero))):
        before = sum(twofloat.residual_kron_df.runtime.launches.values())
        got = twofloat.residual_kron_df(tdf, *given, pads, periodic=periodic,
                                        plan=plan, negate=negate)
        torch.cuda.synchronize()
        assert sum(twofloat.residual_kron_df.runtime.launches.values()) \
            == before + 3
        want = twofloat.residual_kron_df_plain(tdf, *explicit, pads, None,
                                               periodic, negate)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    res = twofloat.k5_resources(plan)
    assert res["registers"] <= 255 and res["blocks_per_sm"] >= 1, res


@pytest.mark.parametrize("p", [9, 12, 16])
def test_k5r_chained_launches_are_bit_equal_to_the_single_pass(dev, p):
    """A 6-term operator sharing nothing (three K5r runs a call, three
    launches each, each run adding onto the sum of the runs before it): the
    single pass's words, with b given and as A.p."""
    npts = (p + 12, p + 13, 2 * p + 20)
    tdf = _k5_terms(npts, (p,) * 3, dev, False, free=6)
    rng = np.random.default_rng(p)
    (xh, xl), (bh, bl) = (twofloat.split_f64(torch.as_tensor(
        rng.standard_normal(npts), device=dev)) for _ in range(2))
    zero = torch.zeros_like(xh)
    plan = twofloat.build_kron_df_plan(tdf, npts, (p,) * 3)
    assert plan.runtime and len(plan.chunks) == 3
    for given, explicit, negate in (((bh, bl, xh, xl), (bh, bl, xh, xl),
                                     False),
                                    ((None, None, xh, None),
                                     (zero, zero, xh, zero), True)):
        before = sum(twofloat.residual_kron_df.runtime.launches.values())
        got = twofloat.residual_kron_df(tdf, *given, (p,) * 3, plan=plan,
                                        negate=negate)
        torch.cuda.synchronize()
        assert sum(twofloat.residual_kron_df.runtime.launches.values()) \
            - before == 9
        want = twofloat.residual_kron_df_plain(tdf, *explicit, (p,) * 3,
                                               negate=negate)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_the_widest_half_width_runs_and_the_next_is_refused(dev):
    """At the widest half-width each run-time kernel takes (K1r 218 in f32
    and bf16, 108 in f64; K5r 138) a small operator runs on the card
    against its plain version; one past it the plan is refused, naming the
    bytes."""
    from poms_tpu_torch.ops import kron as k1
    npts = (5, 6, 9)
    for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
        P = k1.widest_half_width(k1.k1r_smem(itemsize))
        assert P == {4: 218, 8: 108}[itemsize]
        terms, x, real, kw = _k1_case(npts, (P,) * 3, dtype, dev, 0, "cheb")
        plan = build_kron_plan(terms, npts, (P,) * 3, (False,) * 3)
        want = kron_mode_plain(real, terms, x, npts, (P,) * 3, (False,) * 3,
                               diag=plan.diagonal(), **kw)
        for g, w in zip(_on_card(real, plan, x, kw), want):
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert float((g - w).abs().max() / w.abs().max()) <= tol
        terms, _, _, _ = _k1_case(npts, (P + 1,) * 3, dtype, dev, 0, "apply")
        with pytest.raises(RuntimeError, match="bytes of shared memory"):
            build_kron_plan(terms, npts, (P + 1,) * 3, (False,) * 3)
    for four in (False, True):
        P = k1.widest_half_width(twofloat.k5r_smem(4 if four else 3))
        assert P == 138
        tdf = _k5_terms(npts, (P,) * 3, dev, four)
        (xh, xl), (bh, bl) = (twofloat.split_f64(torch.as_tensor(
            np.random.default_rng(P).standard_normal(npts), device=dev))
            for _ in range(2))
        got = twofloat.residual_kron_df(tdf, bh, bl, xh, xl, (P,) * 3)
        torch.cuda.synchronize()
        want = twofloat.residual_kron_df_plain(tdf, bh, bl, xh, xl, (P,) * 3)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        wide = _k5_terms(npts, (P + 1,) * 3, dev, four)
        with pytest.raises(RuntimeError, match="bytes of shared memory"):
            twofloat.build_kron_df_plan(wide, npts, (P + 1,) * 3)


@pytest.mark.parametrize("dim,n_el,degree", [(3, 16, 9), (2, 32, 12)])
@pytest.mark.parametrize("mixed", [True, False], ids=["dw", "f64"])
def test_high_degree_pcg_on_card_matches_cpu(dev, dim, n_el, degree, mixed):
    """The PCG at degrees 9 and 12 on the card against the CPU port, with
    the same λs.  dw (K1r f32 in the cycle, K5r for A.p, K7 between the
    levels): both converge to 1e-8, their counts within a tenth of each
    other; the entries are not compared, since f32 cycles at these degrees
    scatter by 1e-2 to 7e-1 between two orders of summation (the CPU port
    against the JAX package, tests/test_torch_wide_degrees.py).  f64 cycles
    (K1r f64): the first 8 entries of the histories within 1e-8."""
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    runs, lams = {}, None
    for d in (dev, torch.device("cpu")):
        pcg = MGPreconditionedCG(
            poisson_problem(dim, n_el, degree=degree, device=d,
                            operator="kron"), 2, cfg, mixed=mixed,
            operator="kron", precision="dw" if mixed else "f64")
        assert all(lev.A.plan.runtime and lev.A.plan.P == degree
                   for lev in pcg.levels)
        pcg.lams = lams = lams or pcg.lams
        before = dict(counters.snapshot())
        runs[d.type] = pcg.solve(tol=1e-8, maxiter=100)
        if d.type == "cuda":
            grown = counters.diff(counters.snapshot(), before)
            assert all(grown.get(f"kron_mode_rt.cheb.{p}", 0) > 0
                       for p in "ABC"), grown
            if mixed:
                assert pcg._plan_df.runtime and pcg._plan_df.P == degree
                assert all(grown.get(f"residual_kron_df_rt.{p}", 0) > 0
                           for p in "ABC"), grown
    gpu, cpu = runs["cuda"], runs["cpu"]
    if mixed:
        assert gpu.converged and cpu.converged
        assert abs(gpu.iterations - cpu.iterations) <= cpu.iterations // 10
    else:
        for a, b in zip(gpu.residuals[:8], cpu.residuals[:8]):
            assert abs(a - b) <= 1e-8 * b, (a, b)


# -- K1r and K5r pass by pass, and under graph capture -------------------

@pytest.mark.parametrize("npts,pads,periodic,free", [
    ((20, 22, 40), (9, 9, 9), (False,) * 3, 0),
    ((26, 28, 33), (12, 12, 12), (True, False, True), 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, BF16],
                         ids=["f32", "f64", "bf16"])
def test_k1r_passes_match_their_plain_versions(dev, npts, pads, periodic,
                                               free, dtype):
    """Each K1r pass alone against its plain version on the same inputs:
    A from x, B from the u partials A left in the scratch, C (every mode,
    onto the earlier runs' sum) from the pre-summed partials B left there;
    within K1's tolerances of max|y| (bf16: f32 arithmetic, f32 scratch)."""
    from poms_tpu_torch.ops import kron as k1
    work = torch.float64 if dtype == torch.float64 else torch.float32
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    terms, x, _, _ = _k1_case(npts, pads, dtype, dev, free, "apply")
    _, _, _, kw = _k1_case(npts, pads, dtype, dev, free, "cheb")
    plan = build_kron_plan(terms, npts, pads, periodic)
    assert plan.runtime and plan.scratch is not None
    x3 = x.reshape(plan.n3)
    u, w = k1.k1r_scratch_fields(plan)

    def close(got, want):
        if got.dtype == BF16:   # one rounding of the f32 result
            return _bf16_differing(got.cpu(), want.to(BF16).cpu()) \
                <= max(2, got.numel() // 50)
        got, want = got.to(work).cpu(), want.to(work).cpu()
        return float((got - want).abs().max() / want.abs().max()) <= tol

    for r, sp in enumerate(plan.plans):
        acc = (torch.randn(plan.npts, device=dev, dtype=work)
               if r else None)
        k1.k1r_launch_pass("A", plan, r, x3)
        want = k1.k1r_pass_plain("A", plan, sp, x.to(work))
        assert all(close(u[k], want[k]) for k in range(len(want)))
        k1.k1r_launch_pass("B", plan, r, x3)
        want = k1.k1r_pass_plain("B", plan, sp, [t.clone() for t in u])
        assert all(close(w[k], want[k]) for k in range(len(want)))
        src = [t.clone() for t in w[:len(sp["g_lab"])]]
        for mode in K1_MODES:
            b = kw["b"] if mode in ("residual", "cheb") else None
            d = kw["d"] if mode == "cheb" else None
            out = torch.empty(plan.npts, dtype=dtype, device=dev)
            d_out = torch.empty_like(out)
            k1.k1r_launch_pass("C", plan, r, x3, mode, acc=acc, b=b, d=d,
                               d_out=d_out if mode == "cheb" else None,
                               out=out, c1=0.3, c2=0.7)
            diag = (plan.operands_f32()[1] if dtype == BF16
                    else plan.diagonal())
            want = k1.k1r_pass_plain(
                "C", plan, sp, src, mode, x.to(work),
                None if b is None else b.to(work),
                None if d is None else d.to(work), 0.3, 0.7, acc, diag)
            torch.cuda.synchronize()
            if mode == "cheb":
                assert close(out, want[0]) and close(d_out, want[1])
            else:
                assert close(out, want)


@pytest.mark.parametrize("npts,pads,periodic,four", [
    ((20, 22, 40), (9, 9, 9), (False,) * 3, False),
    ((26, 28, 33), (12, 12, 12), (True, False, True), True)])
def test_k5r_passes_are_bit_equal_to_their_plain_versions(dev, npts, pads,
                                                          periodic, four):
    """Each K5r pass alone against its plain version on the same inputs (A
    from x, B from the u pairs A left in the scratch, C from the v pairs B
    left there, b given and as A.p): word for word."""
    tdf = _k5_terms(npts, pads, dev, four)
    rng = np.random.default_rng(len(npts) + 5)
    (xh, xl), (bh, bl) = (twofloat.split_f64(torch.as_tensor(
        rng.standard_normal(npts), device=dev)) for _ in range(2))
    plan = twofloat.build_kron_df_plan(tdf, npts, pads, periodic)
    assert plan.runtime and len(plan.plans) == 1
    sp = plan.plans[0]
    u, v = twofloat.k5r_scratch_fields(plan)
    geo, run = twofloat._df_c_args(plan)[:2]
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    bands = [ptr(t) for pair in zip(plan.bands, plan.bands_lo) for t in pair]
    stream = torch.cuda.current_stream().cuda_stream
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    args = (ptr(xh), ptr(xl), ptr(bh), ptr(bl), None, None, *bands, ptr(rh),
            ptr(rl), geo, run, 0, 1)
    twofloat.k5r_launch_pass("A", plan, args, stream)
    want = twofloat.k5r_pass_plain("A", plan, sp, (xh, xl))
    torch.cuda.synchronize()
    for k, pair in enumerate(want):
        assert all(torch.equal(a, b) for a, b in zip(u[k], pair))
    twofloat.k5r_launch_pass("B", plan, args, stream)
    want = twofloat.k5r_pass_plain("B", plan, sp, [tuple(t.clone() for t in p)
                                                   for p in u])
    torch.cuda.synchronize()
    for k, pair in enumerate(want):
        assert all(torch.equal(a, b) for a, b in zip(v[k], pair))
    src = [tuple(t.clone() for t in p) for p in v]
    twofloat.k5r_launch_pass("C", plan, args, stream)
    want = twofloat.k5r_pass_plain("C", plan, sp, src, bh, bl)
    torch.cuda.synchronize()
    assert torch.equal(rh, want[0].reshape(npts))
    assert torch.equal(rl, want[1].reshape(npts))


def test_degree_9_graph_replay_equals_the_eager_solve(dev):
    """The dw-PCG at degree 9 (K1r in the cycles, K5r for A.p, each plan's
    scratch captured in the graph): solve_compiled's replayed history
    equals the eager solve's entry for entry."""
    prob = poisson_problem(3, 16, degree=9, device=dev, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    pcg = MGPreconditionedCG(prob, 2, cfg, mixed=True, operator="kron",
                             precision="dw")
    assert pcg._plan_df.runtime and pcg._plan_df.scratch is not None
    eager = pcg.solve(tol=1e-10, maxiter=30)
    x, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=30)
    x, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=30)   # replayed
    assert int(it) == eager.iterations
    assert float(rn) == eager.residuals[-1]


def test_each_graph_replay_range_owns_its_kernels(dev, tmp_path):
    """A 64^3 dw-PCG solve replayed under the profiler with a recording:
    every ``poms.graph.replay`` range owns the kernels of one replay (tied
    through its cudaGraphLaunch), as many for each and at least the
    hand-written ones the counters add a replay; the step writes x, r, z
    and p into the graph's own buffers, so the copy-back counter advances by
    twice ρ's 8 bytes a replay and the in-place counter by those fields'
    bytes."""
    import sys

    from torch.profiler import ProfilerActivity, profile

    repo = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from benchmark import spans as bspans
    from benchmark import trace as btrace
    from benchmark.harness import hand_kernels
    from poms_tpu_torch.utils import trace

    prob = poisson_problem(3, 64, degree=3, device=dev, operator="kron")
    pcg = MGPreconditionedCG(prob, 4, _cheb_cfg(), mixed=True,
                             operator="kron", precision="dw")
    pcg.solve_compiled(tol=1e-10, maxiter=40)          # capture
    graph = pcg._graphs["dw"]
    n = 65 ** 3                   # the unknowns of 64^3 cubic elements
    assert graph.captured["graph.copy_bytes"] == 2 * 8
    assert graph.captured["graph.inplace_bytes"] == 6 * 4 * n
    torch.cuda.synchronize()
    before = counters.snapshot()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording() as records:
            _, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=40)
            torch.cuda.synchronize()
    grown = counters.diff(counters.snapshot(), before)
    path = tmp_path / "replayed.json"
    prof.export_chrome_trace(str(path))
    events = btrace.load(path)
    joined = bspans.join(events, records)
    ops = bspans.owned(events, joined)
    kernels = [sum(op.get("cat") == "kernel" for op in ops.get(r.id, ()))
               for r, _ in joined if r.name == "poms.graph.replay"]
    assert len(kernels) == it > 0
    assert min(kernels) == max(kernels) >= max(1, hand_kernels(
        graph.captured))
    for key in ("graph.copy_bytes", "graph.inplace_bytes"):
        assert grown[key] == it * graph.captured[key]
    start = [r.id for r, _ in joined if r.name == "poms.solve.start"]
    start_kernels = sum(op.get("cat") == "kernel" for op in ops[start[0]])
    assert sum(kernels) + start_kernels >= hand_kernels(grown)
    assert len(bspans.replay_gaps(joined, ops)) == it - 1


def test_dw_graph_writes_its_own_buffers_bit_equal_to_the_eager_solve(dev):
    """64^3 p3 dw-PCG: the replayed in-place step gives the eager solve's x
    words, ‖r‖ and count; the graph's state buffers stay where they were
    across replays and solves, and the step returns them as themselves."""
    prob = poisson_problem(3, 64, degree=3, device=dev, operator="kron")
    pcg = MGPreconditionedCG(prob, 4, _cheb_cfg(), mixed=True,
                             operator="kron", precision="dw")
    eager = pcg.solve(tol=1e-10, maxiter=40)
    x, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=40)
    graph = pcg._graphs["dw"]
    ptrs = [t.data_ptr() for t in graph.state]
    assert it == eager.iterations > 1 and graph.replays == it
    assert float(rn) == eager.residuals[-1]
    assert torch.equal(x.interior, eager.x.interior)
    x2, rn2, it2 = pcg.solve_compiled(tol=1e-10, maxiter=40)
    assert it2 == it and float(rn2) == float(rn)
    assert torch.equal(x2.interior, x.interior)
    assert [t.data_ptr() for t in graph.state] == ptrs
    bufs = [t.clone() for t in graph.state]
    new = pcg._step_dw(*bufs, inplace=True)
    assert all(a is b for a, b in zip(new[:6], bufs[:6]))


def test_k6u_out_aliasing_its_inputs_is_bit_equal(dev):
    """K6u in every mode with ``out`` aliasing its operands as the in-place
    step does (x and r for cg, p for direction, the field for mul and div,
    x for defect and dwrr, rf for dwrr) and with fresh ``out`` fields: the
    allocating call's words; a wrong out raises before any launch."""
    n = 65 ** 3
    g = torch.Generator().manual_seed(7)
    f = [torch.randn(n, generator=g).to(dev) for _ in range(7)]
    for k in (1, 3, 6):
        f[k] *= 1e-8
    s0 = torch.tensor(0.37, dtype=torch.float64, device=dev)
    s1 = torch.tensor(1.91, dtype=torch.float64, device=dev)
    cases = [("cg", (*f, s0, s1), (0, 1, 2, 3, None, None)),
             ("direction", (f[0], f[2], s0, s1), (1,)),
             ("defect", (f[0], f[1], f[2], s0), (0, 1)),
             ("dwrr", (f[0], f[1], f[2], f[4], f[5], s0, s1),
              (0, 1, None, 4)),
             ("dwrr", (f[0], f[1], f[2], None, None, s0, s1), (0, 1)),
             ("div", (f[0], s0), (0,)), ("mul", (f[0], s0), (0,))]
    for mode, ops, alias in cases:
        want = twofloat.dw_update(mode, *ops)
        want = (want,) if isinstance(want, torch.Tensor) else want
        fresh = [torch.empty_like(f[0]) for _ in alias]
        got = twofloat.dw_update(mode, *ops, out=fresh)
        got = (got,) if isinstance(got, torch.Tensor) else got
        assert all(torch.equal(a, b) for a, b in zip(got, want)), mode
        ops = [None if t is None else t.clone() for t in ops]
        out = [ops[j] if j is not None else torch.empty_like(f[0])
               for j in alias]
        before = twofloat.dw_update.launches
        got = twofloat.dw_update(mode, *ops, out=out)
        assert twofloat.dw_update.launches == before + 1
        got = (got,) if isinstance(got, torch.Tensor) else got
        assert all(a is b for a, b in zip(got, out)), mode
        assert all(torch.equal(a, b) for a, b in zip(got, want)), mode
    before = twofloat.dw_update.launches
    with pytest.raises(ValueError):
        twofloat.dw_update("mul", f[0], s0, out=(f[1][1:],))
    with pytest.raises(TypeError):
        twofloat.dw_update("mul", f[0], s0, out=(f[1].double(),))
    with pytest.raises(ValueError):
        twofloat.dw_update("mul", f[0], s0, out=(f[1], f[2]))
    assert twofloat.dw_update.launches == before


# -- kron.partial_bytes: the partial sum between K1's runs of terms ----------

def _cast_terms(terms, dtype):
    """The terms in ``dtype``, one cast a distinct band (the sharing kept)."""
    cast = {}
    return [[cast.setdefault(id(B), B.to(dtype)) for B in term]
            for term in terms]


def _unfoldable_terms(A):
    """Four terms of the periodic operator ``A``'s bands with three distinct
    axis-0 bands, no two sharing two axes' bands (σM⊗K⊗K, K⊗M⊗M, M⊗K⊗M,
    M⊗M⊗K): K1's plan folds none and takes two runs."""
    (S, _, _), (K0, M1, M2), (M0, K1, _), (_, _, K2) = A.terms
    return [[S, K1, K2], [K0, M1, M2], [M0, K1, M2], [M0, M1, K2]]


@pytest.mark.parametrize("degree,dtype", [
    (3, torch.float32), (3, torch.float64), (3, BF16), (5, torch.float32)],
    ids=["p3-f32", "p3-f64", "p3-bf16", "p5-f32-k1r"])
def test_kron_partial_bytes_counts_the_sum_between_runs(dev, degree, dtype):
    """Each K1 (K1r at degree 5) call on a four-term operator that no fold
    brings into one run, in every mode, advances ``kron.partial_bytes`` by
    2 × n × the partial sum's bytes (f32 for a bf16 operator), eagerly and
    at every replay of a captured graph; the periodic shifted operator,
    whose plan folds σ·M⊗M⊗M + K⊗M⊗M into one term, and the three-term
    Dirichlet operator take one run a call (one launch; K1r three, one a
    pass) and leave it at 0."""
    from poms_tpu_torch.mg.graph import GraphedStep

    key = "kron.partial_bytes"
    per = periodic_problem(3, 32, degree=degree, operator="kron", device=dev)
    pois = poisson_problem(3, 32, degree=degree, operator="kron", device=dev)
    g = torch.Generator(device=dev).manual_seed(degree)
    for A, terms, runs, folded in ((per.A, _unfoldable_terms(per.A), 2, 0),
                                   (per.A, per.A.terms, 1, 1),
                                   (pois.A, pois.A.terms, 1, 0)):
        sp = A.space
        plan = build_kron_plan(_cast_terms(terms, dtype), sp.npts, sp.pads,
                               sp.periodic)
        assert len(plan.plans) == runs
        assert plan.n_terms == len(terms) - folded
        launches = runs * (3 if plan.runtime else 1)
        n = plan.n3[0] * plan.n3[1] * plan.n3[2]
        want = (runs - 1) * 2 * n * (8 if dtype == torch.float64 else 4)
        x, b = (torch.randn(plan.npts, generator=g, dtype=torch.float32,
                            device=dev).to(dtype) for _ in range(2))
        for mode in K1_MODES:
            before = counters.snapshot()
            kron_mode(mode, plan, x, b=b if mode in ("residual", "cheb")
                      else None)
            torch.cuda.synchronize()
            grown = counters.diff(counters.snapshot(), before)
            assert grown.get(key, 0) == want, mode
            assert sum(grown.get(f"kron_mode.{m}", 0) for m in K1_MODES) \
                == launches, mode

        def step(x, b):
            y, d = kron_mode("cheb", plan, x, b=b, c2=0.5)
            return y, torch.linalg.vector_norm(d.float())

        graph = GraphedStep(step, [x], [b])
        assert graph.captured.get(key, 0) == want
        before = counters.snapshot()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        grown = counters.diff(counters.snapshot(), before)
        assert grown.get(key, 0) == 3 * want
        assert sum(grown.get(f"kron_mode.{m}", 0) for m in K1_MODES) \
            == 3 * launches
