"""The port's banded transfers against ``poms_tpu.ops.transfer``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poms_tpu.models.bspline import prolongation_interior_1d
from poms_tpu.ops import transfer as ref
from poms_tpu_torch import convert
from poms_tpu_torch.ops import transfer as port

torch.set_num_threads(1)

CASES = [(4, 1), (4, 2), (8, 3), (16, 3)]


@pytest.mark.parametrize("n_el_c,p", CASES)
def test_bands_from_dense_equal(n_el_c, p):
    P = prolongation_interior_1d(n_el_c, p)
    for M in (P, P.T):
        rb, pb = ref.bands_from_dense(M), port.bands_from_dense(M, device="cpu")
        w = np.asarray(rb.w)
        assert w.dtype == np.float64
        np.testing.assert_array_equal(pb.w.numpy(), w)
        np.testing.assert_array_equal(pb.c0.numpy(), np.asarray(rb.c0))
        assert pb.c0.dtype == torch.int64
        assert pb.n_in == rb.n_in and pb.width == rb.width


@pytest.mark.parametrize("n_el_c,p", CASES)
@pytest.mark.parametrize("dtype,tol", [(64, 1e-14), (32, 1e-6)])
def test_apply_transfer_matches_jax(n_el_c, p, dtype, tol):
    """3D restriction and prolongation, ≤ tol of max|y|."""
    jdt = {64: jnp.float64, 32: jnp.float32}[dtype]
    P = prolongation_interior_1d(n_el_c, p)
    nf, nc = P.shape
    rng = np.random.default_rng(n_el_c + p)
    for M, shape in ((P, (nc, nc + 0, nc)), (P.T, (nf, nf, nf))):
        rbs = tuple(ref.bands_from_dense(M, jdt) for _ in range(3))
        pbs = tuple(convert.transfer_band(tb) for tb in rbs)
        x = rng.standard_normal(shape).astype(np.dtype(jdt))
        want = np.asarray(ref.apply_transfer(rbs, jnp.asarray(x)))
        assert want.dtype == np.dtype(jdt)
        got = port.apply_transfer(pbs, torch.from_numpy(x))
        assert got.dtype == pbs[0].w.dtype and got.shape == want.shape
        assert (np.abs(got.numpy() - want).max()
                <= tol * np.abs(want).max())


@pytest.mark.parametrize("n_el_c,p", CASES)
@pytest.mark.parametrize("dtype,tol", [(64, 1e-14), (32, 1e-6)])
def test_prolongation_with_add_matches_jax(n_el_c, p, dtype, tol):
    """The fused epilogue x + P·x_c (mg/cycles.py) against the reference's
    two lines, 2D, ≤ tol of max|y| (as the test above);
    ``apply_transfer_plain`` is what the wrapper runs on the CPU."""
    jdt = {64: jnp.float64, 32: jnp.float32}[dtype]
    P = prolongation_interior_1d(n_el_c, p)
    nf, nc = P.shape
    rng = np.random.default_rng(3 * n_el_c + p)
    rbs = tuple(ref.bands_from_dense(P, jdt) for _ in range(2))
    pbs = tuple(convert.transfer_band(tb) for tb in rbs)
    xc = rng.standard_normal((nc, nc)).astype(np.dtype(jdt))
    xf = rng.standard_normal((nf, nf)).astype(np.dtype(jdt))
    want = np.asarray(jnp.asarray(xf)
                      + ref.apply_transfer(rbs, jnp.asarray(xc)))
    got = port.apply_transfer(pbs, torch.from_numpy(xc),
                              add=torch.from_numpy(xf))
    assert got.dtype == pbs[0].w.dtype and want.dtype == np.dtype(jdt)
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    assert torch.equal(got, port.apply_transfer_plain(
        pbs, torch.from_numpy(xc), add=torch.from_numpy(xf)))
    assert torch.equal(port.apply_transfer(pbs, torch.from_numpy(xc)),
                       port.apply_transfer_plain(pbs, torch.from_numpy(xc)))


def test_cpu_transfer_launches_no_kernel():
    P = prolongation_interior_1d(4, 2)
    tb = port.bands_from_dense(P, device="cpu")
    before = port.apply_transfer.launches
    port.apply_transfer((tb,), torch.ones(P.shape[1], dtype=torch.float64))
    assert port.apply_transfer.launches == before


@pytest.mark.parametrize("n_el_c,p", CASES[1:3])
def test_bf16_transfer_rounds_once_per_axis(n_el_c, p):
    """K7's bf16 plain version: each axis' taps multiplied and added in f32
    on the bf16 weights and field, the addend inside the last axis' sum, one
    rounding per axis; a bf16 field stays bf16 and counts no launch."""
    bf16, f32 = torch.bfloat16, torch.float32
    P = prolongation_interior_1d(n_el_c, p)
    nf, nc = P.shape
    rng = np.random.default_rng(n_el_c)
    tbs = tuple(port.bands_from_dense(P, bf16, "cpu") for _ in range(2))
    hi = tuple(port.TransferBand(w=tb.w.to(f32), c0=tb.c0, n_in=tb.n_in)
               for tb in tbs)
    x = torch.from_numpy(rng.standard_normal((nc, nc))).to(bf16)
    add = torch.from_numpy(rng.standard_normal((nf, nf))).to(bf16)
    before = port.apply_transfer.launches
    got = port.apply_transfer(tbs, x, add=add)
    assert got.dtype == bf16 and port.apply_transfer.launches == before
    mid = port.apply_transfer_axis(hi[0], x.to(f32), 0).to(bf16)
    want = (add.to(f32) + port.apply_transfer_axis(hi[1], mid.to(f32), 1)
            ).to(bf16)
    assert torch.equal(got, want)
    assert torch.equal(port.apply_transfer(tbs[:1], x[:, 0]),
                       port.apply_transfer_axis(hi[0], x[:, 0].to(f32),
                                                0).to(bf16))
