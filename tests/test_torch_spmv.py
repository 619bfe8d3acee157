"""K2's plain modes (``poms_tpu_torch.ops.dispatch`` on CPU tensors) against
``poms_tpu.ops.dispatch`` on the CPU, which takes its jnp branch: the same
shifted-multiply-add sums in the same offset order.

Tolerances: max|Δ|/max|y| ≤ 1e-13 in f64 and ≤ 1e-5 in f32 (XLA may fuse
the sum and contract multiply-adds; the order of the terms is the same);
``color_mask`` bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poms_tpu.mg.smoother import color_mask as ref_color_mask
from poms_tpu.ops import dispatch as ref_dispatch
from poms_tpu.ops.spmv import spmv_offdiag_jnp
from poms_tpu_torch.ops import dispatch
from poms_tpu_torch.ops.stencil import (color_mask, diagonal_band_index,
                                        spmv_offdiag_plain, stencil_apply)

torch.set_num_threads(1)

CASES = [((40,), (1,), None), ((33,), (3,), (5,)),
         ((9, 11), (2, 1), None), ((12, 10), (3, 3), (1, 4)),
         ((6, 7, 8), (1, 2, 1), None), ((7, 6, 9), (3, 3, 3), (2, 0, 1)),
         ((5, 5, 6), (2, 2, 2), (1, 1, 1))]
DTYPES = {64: (np.float64, jnp.float64, torch.float64, 1e-13),
          32: (np.float32, jnp.float32, torch.float32, 1e-5)}


def _operands(npts, pads, bits, seed=0):
    """Random band (diagonal shifted away from 0), ghosted x and b."""
    np_dt, jdt, tdt, _ = DTYPES[bits]
    rng = np.random.default_rng(seed)
    band = rng.standard_normal(tuple(2 * p + 1 for p in pads) + npts) / 8
    band[tuple(pads)] += 4.0
    x_pad = rng.standard_normal(tuple(n + 2 * p for n, p in zip(npts, pads)))
    b = rng.standard_normal(npts)
    band, x_pad, b = (a.astype(np_dt) for a in (band, x_pad, b))
    return ((jnp.asarray(band), jnp.asarray(x_pad), jnp.asarray(b)),
            (torch.from_numpy(band), torch.from_numpy(x_pad),
             torch.from_numpy(b)))


def _close(got, want, bits):
    want = np.asarray(want)
    assert want.dtype == DTYPES[bits][0]
    got = got.numpy()
    assert got.dtype == want.dtype
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= DTYPES[bits][3], rel


@pytest.mark.parametrize("npts,pads,starts", CASES)
@pytest.mark.parametrize("bits", [64, 32])
def test_spmv_and_residual(npts, pads, starts, bits):
    (jb, jx, jr), (tb, tx, tr) = _operands(npts, pads, bits, seed=len(npts))
    _close(dispatch.spmv(tb, tx, npts, pads),
           ref_dispatch.spmv(jb, jx, npts, pads), bits)
    _close(dispatch.residual(tb, tx, tr, npts, pads),
           ref_dispatch.residual(jb, jx, jr, npts, pads), bits)


@pytest.mark.parametrize("npts,pads,starts", CASES)
@pytest.mark.parametrize("bits", [64, 32])
def test_jacobi(npts, pads, starts, bits):
    (jb, jx, jr), (tb, tx, tr) = _operands(npts, pads, bits, seed=7)
    _close(dispatch.jacobi(tb, tx, tr, 0.7, npts, pads),
           ref_dispatch.jacobi(jb, jx, jr, 0.7, npts, pads), bits)


@pytest.mark.parametrize("npts,pads,starts", CASES)
@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("color", [0, 1])
def test_rbgs_color(npts, pads, starts, bits, color):
    """One colour phase; points of the other colour keep x bit for bit."""
    (jb, jx, jr), (tb, tx, tr) = _operands(npts, pads, bits, seed=11)
    got = dispatch.rbgs_color(tb, tx, tr, 0.9, color, npts, pads, starts)
    want = ref_dispatch.rbgs_color(jb, jx, jr, 0.9, color, npts, pads,
                                   starts)
    _close(got, want, bits)
    x_int = tx[tuple(slice(p, p + n) for n, p in zip(npts, pads))]
    other = ~color_mask(npts, color, starts, device="cpu")
    assert torch.equal(got[other], x_int[other])


@pytest.mark.parametrize("npts,pads,starts", CASES)
def test_offdiag_and_diagonal_index(npts, pads, starts):
    (jb, jx, _), (tb, tx, _) = _operands(npts, pads, 64, seed=3)
    assert diagonal_band_index(pads) == tuple(pads)
    _close(spmv_offdiag_plain(tb, tx, npts, pads),
           spmv_offdiag_jnp(jb, jx, npts, pads), 64)


@pytest.mark.parametrize("npts,starts", [((7,), None), ((6, 9), (1, 0)),
                                         ((5, 6, 7), (3, 2, 5)),
                                         ((4, 4, 4), (0, 0, 1))])
@pytest.mark.parametrize("color", [0, 1])
def test_color_mask_bitwise(npts, starts, color):
    want = np.asarray(ref_color_mask(npts, color, starts))
    np.testing.assert_array_equal(color_mask(npts, color, starts,
                                             device="cpu").numpy(),
                                  want)


def test_wrapper_checks_its_arguments():
    (_, _, _), (tb, tx, tr) = _operands((6, 7), (1, 2), 64)
    with pytest.raises(ValueError):
        stencil_apply("residual", tb, tx, (6, 7), (1, 2))     # no b
    with pytest.raises(ValueError):
        stencil_apply("spmv", tb, tx, (6, 7), (1, 2), b=tr)   # stray b
    with pytest.raises(ValueError):
        stencil_apply("jacobi", tb, tx, (6, 7), (1, 2), b=tr)  # no omega
    with pytest.raises(ValueError):
        stencil_apply("sweep", tb, tx, (6, 7), (1, 2))
    with pytest.raises(NotImplementedError):
        stencil_apply("spmv", tb.to("meta"), tx.to("meta"), (6, 7), (1, 2))
