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
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import twofloat
from poms_tpu_torch.ops.kron import (MODES as K1_MODES, build_kron_plan,
                                     kron_apply, kron_apply_plain, kron_mode,
                                     kron_mode_plain)
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
    """p = 20: no kernel is compiled for that half-width, the launcher
    refuses, the wrapper raises, and the next launch runs."""
    terms, x = _operands((4, 5, 6), 20, torch.float32, dev)
    before = dict(kron_mode.launches)
    with pytest.raises(RuntimeError):
        kron_apply(terms, x, (4, 5, 6), (20,) * 3, (False,) * 3)
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
    4-term operator that takes two launches: within K1's tolerance of the
    plain version (summation order, FMA)."""
    terms, (x, b, d) = _mode_operands(npts, pads, dtype, dev, free,
                                      seed=sum(npts))
    plan = build_kron_plan(terms, npts, pads, periodic)
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
    before = dict(kron_mode.launches)
    kw_k = dict(kw, d=d.clone()) if kw.get("d") is not None else kw
    got = kron_mode(mode, plan, x_view, **kw_k)
    torch.cuda.synchronize()
    # one launch per run of terms: the last in ``mode``, the others ``apply``
    before[mode] += 1
    before["apply"] += len(plan.plans) - 1
    assert kron_mode.launches == before
    want = kron_mode_plain(mode, terms, x, npts, pads, periodic,
                           diag=plan.diagonal(), **kw)
    if mode != "cheb":
        got, want = (got,), (want,)
    else:
        assert kw_k.get("d") is None or got[1] is kw_k["d"]   # in place
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= tol


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


def test_k5_refuses_what_it_lacks(dev):
    rng = np.random.default_rng(0)
    free = [[twofloat.split_f64(torch.as_tensor(
        rng.standard_normal((9, 3)), device=dev)) for _ in range(2)]
        for _ in range(5)]
    xh = torch.zeros((9, 9), device=dev)
    with pytest.raises(RuntimeError):     # five sharing-free terms
        twofloat.residual_kron_df(free, None, None, xh, None, (1, 1))
    with pytest.raises(TypeError):
        twofloat.residual_kron_df(free[:1], None, None, xh.double(), None,
                                  (1, 1))


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
