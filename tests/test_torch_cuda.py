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
from poms_tpu_torch.ops.kron import kron_apply, kron_apply_plain
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
    with pytest.raises(NotImplementedError):
        kron_apply([t[:2] for t in terms], x[0], (7, 8), (1, 1),
                   (False, False))
    with pytest.raises(ValueError):
        kron_apply(terms, x[:5], (6, 7, 8), (1,) * 3, (False,) * 3)


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
        before = kron_apply.launches
        runs[d.type] = pcg.solve(tol=1e-10, maxiter=30)
        if d.type == "cuda":
            assert kron_apply.launches > before
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
