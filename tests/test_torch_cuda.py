"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -o addopts=''
"""
import numpy as np
import pytest
import torch

from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops.kron import kron_apply, kron_apply_plain

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
        pcg = MGPreconditionedCG(poisson_problem(3, 16, degree=3, device=d),
                                 2, cfg, precision="dw")
        pcg.lams = lams = lams or pcg.lams
        before = kron_apply.launches
        runs[d.type] = pcg.solve(tol=1e-10, maxiter=30)
        if d.type == "cuda":
            assert kron_apply.launches > before
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.converged and gpu.iterations == cpu.iterations
    xg, xc = gpu.x.interior.cpu(), cpu.x.interior
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-6
