"""The kernel-limit probes' plain versions, and the roofline table.

K4v's plain version and K4a ``full`` are the banded SpMV: held against the
JAX package's ``spmv_banded_jnp`` (f32, max|Δ| ≤ 1e-5 with rtol 1e-5, the
sum order being the same up to XLA's fusion).  K4c and the K4a
``noshift``/``nolane``/``nomul`` variants are deliberately not the SpMV:
each is held against an independent numpy loop over points and offsets
(1e-5).  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poms_tpu.ops.spmv import spmv_banded_jnp
from poms_tpu_torch.bench import kernel_probe as kp
from poms_tpu_torch.bench import roofline

torch.set_num_threads(1)

SHAPES = [((6, 9, 35), 1), ((8, 16, 64), 2), ((5, 10, 40), 3)]


def _operands(npts, p, seed=0):
    rng = np.random.default_rng(seed)
    w = 2 * p + 1
    band = (rng.standard_normal((w,) * 3 + npts) / (2 * w ** 1.5)
            ).astype(np.float32)
    x_pad = rng.standard_normal(tuple(n + 2 * p for n in npts)
                                ).astype(np.float32)
    return band, x_pad


def _numpy_probe(variant, band, x_pad, npts, p):
    """Point by point: out[i] = Σ_k c(k, i)·x_pad[i + s(k)] in float64."""
    w = 2 * p + 1
    pin0, pinq = kp.k2_pinned(npts)
    out = np.zeros(npts)
    for i in itertools.product(*map(range, npts)):
        acc = 0.0
        for k in itertools.product(range(w), repeat=3):
            s = list(k)
            if variant == "noshift":
                s[1] = 0
            if variant == "nolane":
                s[2] = 0
            xv = float(x_pad[tuple(a + b for a, b in zip(i, s))])
            if variant == "nomul":
                acc += xv
                continue
            if variant == "compute":   # the same place in block (0, 0)
                q = int(pinq[i[1] * npts[2] + i[2]])
                bi = (int(pin0[i[0]]),) + divmod(q, npts[2])
            else:
                bi = i
            acc += float(band[k + bi]) * xv
        out[i] = acc
    return out


@pytest.mark.parametrize("npts,p", SHAPES)
@pytest.mark.parametrize("variant", ["compute", "noshift", "nolane",
                                     "nomul"])
def test_probe_plain_matches_numpy(npts, p, variant):
    band, x_pad = _operands(npts, p, seed=p)
    got = kp.stencil_probe(variant, torch.from_numpy(band),
                           torch.from_numpy(x_pad), npts, (p,) * 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == npts
    want = _numpy_probe(variant, band, x_pad, npts, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("npts,p", SHAPES)
@pytest.mark.parametrize("probe", ["v15", "full"])
def test_spmv_probes_match_jax(npts, p, probe):
    band, x_pad = _operands(npts, p, seed=10 + p)
    args = (torch.from_numpy(band), torch.from_numpy(x_pad), npts, (p,) * 3)
    got = (kp.v15_apply(*args) if probe == "v15"
           else kp.stencil_probe("full", *args))
    want = spmv_banded_jnp(jnp.asarray(band), jnp.asarray(x_pad), npts,
                           (p,) * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_probe_wrappers_refuse():
    band, x_pad = (torch.from_numpy(a) for a in _operands((4, 8, 32), 1))
    with pytest.raises(ValueError, match="unknown probe variant"):
        kp.stencil_probe("halfdma", band, x_pad, (4, 8, 32), (1,) * 3)
    with pytest.raises(ValueError, match="ablate variant"):
        kp.probe_ablate(32, 1, "compute")
    with pytest.raises(ValueError, match="t2=16"):
        kp.probe_ablate(32, 1, "full", t2=16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        kp.probe_compute(16, 1, device="cpu")
    with pytest.raises(SystemExit):
        kp.main(["bandreuse", "16", "1"])


@pytest.mark.parametrize("n,edge", [(128, 128), (129, 132), (33, 36),
                                    (4, 4)])
def test_compute_floor_measures_k4_at_a_size_it_takes(n, edge):
    """K4 takes n % 4 == 0 only: the compute probe at a 2^k + 1 grid
    measures its ceiling at the next such edge."""
    assert kp.stream_edge(n) == edge
    band = kp.make_band(edge, 1, False, "cpu")
    x = torch.zeros((edge,) * 3)
    assert tuple(kp.stream_probe(band, x, False).shape) == (edge,) * 3


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 SXM5 80GB", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0)])
def test_sol_bandwidth_by_card_name(name, gbps):
    assert roofline.sol_bandwidth(name) == gbps


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                                  "NVIDIA H100 NVL"])
def test_sol_bandwidth_refuses_an_unknown_card(name):
    with pytest.raises(ValueError, match="no device-memory bandwidth"):
        roofline.sol_bandwidth(name)


def test_bench_spmv_needs_a_card():
    with pytest.raises(ValueError, match="impl"):
        roofline.bench_spmv((8, 8, 8), impl="pallas")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the bench would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.bench_spmv((8, 8, 8), impl="k3")
