"""The port's banded transfers against ``poms_tpu.ops.transfer``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poms_tpu.models.bspline import (prolongation_interior_1d,
                                      prolongation_periodic_1d)
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


# -- periodic transfers: the narrowest cyclic band ---------------------------

TDT = {64: torch.float64, 32: torch.float32}
PERIODIC = [(n_el_c, p) for n_el_c in (4, 8) for p in (1, 2, 3)
            if n_el_c > p]


def _lifted(tbs):
    return (None,) * (3 - len(tbs)) + tuple(tbs)


@pytest.mark.parametrize("n_el_c,p", PERIODIC)
def test_periodic_bands_wrap(n_el_c, p):
    """A periodic prolongation and its transpose band as wrapped rows of
    ceil((p+2)/2) and p + 2 taps, each the dense matrix's row."""
    P = prolongation_periodic_1d(n_el_c, p)
    for M, width in ((P, (p + 3) // 2), (P.T, p + 2)):
        tb = port.bands_from_dense(M, device="cpu")
        assert tb.wrap and tb.width == width and tb.n_in == M.shape[1]
        assert tb.c0.dtype == torch.int64
        assert bool(((tb.c0 >= 0) & (tb.c0 < tb.n_in)).all())
        assert bool((tb.c0 + tb.width > tb.n_in).any())   # some rows wrap
        dense = np.zeros(M.shape)
        cols = (tb.c0.numpy()[:, None] + np.arange(width)) % tb.n_in
        dense[np.arange(M.shape[0])[:, None], cols] = tb.w.numpy()
        np.testing.assert_array_equal(dense, M)
        assert ref.bands_from_dense(M).width == M.shape[1]


@pytest.mark.parametrize("n_el_c,p", CASES)
def test_open_knot_bands_do_not_wrap(n_el_c, p):
    """Open-knot transfers keep the reference's plain bands."""
    P = prolongation_interior_1d(n_el_c, p)
    for M in (P, P.T):
        tb = port.bands_from_dense(M, device="cpu")
        assert not tb.wrap and tb.width == ref.bands_from_dense(M).width


@pytest.mark.parametrize("n_el_c,p", PERIODIC)
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", [64, 32])
def test_wrapped_transfer_matches_jax(n_el_c, p, d, dtype):
    """Restriction and prolongation + add with the wrapped bands: the bits
    of the reference's W = n_in evaluation, up to the sign of a zero.  The
    reference runs op by op (``jax.disable_jit``): under jit XLA may fuse a
    multiply and an add, one rounding fewer."""
    jdt = {64: jnp.float64, 32: jnp.float32}[dtype]
    P = prolongation_periodic_1d(n_el_c, p)
    nf, nc = P.shape
    rng = np.random.default_rng(100 * n_el_c + 10 * p + d)
    xf = rng.standard_normal((nf,) * d).astype(np.dtype(jdt))
    xc = rng.standard_normal((nc,) * d).astype(np.dtype(jdt))
    for M, x, add in ((P.T, xf, None), (P, xc, xf)):
        rbs = tuple(ref.bands_from_dense(M, jdt) for _ in range(d))
        pbs = tuple(port.bands_from_dense(M, TDT[dtype], "cpu")
                    for _ in range(d))
        assert all(tb.wrap for tb in pbs)
        with jax.disable_jit():
            want = ref.apply_transfer(rbs, jnp.asarray(x))
            if add is not None:
                want = jnp.asarray(add) + want
        want = torch.from_numpy(np.array(want))
        got = port.apply_transfer(
            pbs, torch.from_numpy(x),
            add=None if add is None else torch.from_numpy(add))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got + 0.0, want + 0.0)


@pytest.mark.parametrize("n_el_c,p", PERIODIC)
@pytest.mark.parametrize("d", [2, 3])
def test_wrapped_transfer_bf16_matches_full_width(n_el_c, p, d):
    """In bf16 (f32 sums rounded once per axis) the wrapped bands give the
    bits of the port's own W = n_in evaluation, up to the sign of a zero."""
    bf16 = torch.bfloat16
    P = prolongation_periodic_1d(n_el_c, p)
    nf, nc = P.shape
    rng = np.random.default_rng(7 * n_el_c + p + d)
    xf = torch.from_numpy(rng.standard_normal((nf,) * d)).to(bf16)
    xc = torch.from_numpy(rng.standard_normal((nc,) * d)).to(bf16)
    for M, x, add in ((P.T, xf, None), (P, xc, xf)):
        wrapped = tuple(port.bands_from_dense(M, bf16, "cpu")
                        for _ in range(d))
        rb = ref.bands_from_dense(M)
        full = (port.TransferBand(
            w=torch.as_tensor(np.array(rb.w)).to(bf16),
            c0=torch.as_tensor(np.array(rb.c0)), n_in=rb.n_in),) * d
        assert full[0].width == M.shape[1] and not full[0].wrap
        got = port.apply_transfer(wrapped, x, add=add)
        want = port.apply_transfer_plain(full, x, add=add)
        assert got.dtype == bf16
        assert torch.equal(got.float() + 0.0, want.float() + 0.0)


@pytest.mark.parametrize("n_el_c,p", PERIODIC)
def test_convert_rebands_wrapped_transfers(n_el_c, p):
    """The reference's W = n_in periodic band carried across is the port's
    wrapped band of the same matrix; an open-knot band is carried as it is."""
    P = prolongation_periodic_1d(n_el_c, p)
    for M in (P, P.T):
        for jdt, tdt in ((jnp.float64, torch.float64),
                         (jnp.float32, torch.float32)):
            tb = convert.transfer_band(ref.bands_from_dense(M, jdt))
            want = port.bands_from_dense(M, tdt, "cpu")
            assert tb.wrap and tb.width == want.width
            assert tb.w.dtype == tdt and torch.equal(tb.w, want.w)
            assert torch.equal(tb.c0, want.c0)
    Q = prolongation_interior_1d(n_el_c, p)
    rb = ref.bands_from_dense(Q)
    tb = convert.transfer_band(rb)
    assert not tb.wrap and tb.width == rb.width
    np.testing.assert_array_equal(tb.w.numpy(), np.asarray(rb.w))


@pytest.mark.parametrize("kind", ["periodic", "open"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n_el_c", [4, 8, 32, 64])
def test_tiling_stages_every_row_a_tile_reads(kind, d, n_el_c):
    """The fused kernel's launch data: for every tile of every output axis,
    the run of input rows its outputs read (from the tile's first c0,
    cyclically) fits the staged L rows, the tiles cover the axis, and the
    staging and the tables of a run of planes fit a block's shared
    memory."""
    p = 3
    P = (prolongation_periodic_1d(n_el_c, p) if kind == "periodic"
         else prolongation_interior_1d(n_el_c, p))
    for M in (P, P.T):
        tbs = _lifted([port.bands_from_dense(M, device="cpu")] * d)
        for itemsize in (4, 8):
            T1, T2, L1, L2, chunk = port.transfer_tiling(tbs, itemsize)
            assert port._smem_bytes(tbs, T1, T2, L1, L2, chunk,
                                    itemsize) <= port.SMEM_LIMIT
            m0 = 1 if tbs[0] is None else tbs[0].n_out
            assert 1 <= chunk <= m0
            for tb, T, L in ((tbs[1], T1, L1), (tbs[2], T2, L2)):
                if tb is None:
                    assert T == 1 and L == 1
                    continue
                c0 = tb.c0.numpy()
                assert 1 <= T <= tb.n_out
                for first in range(0, tb.n_out, T):
                    rows = c0[first:first + T]
                    reach = np.mod(rows - rows[0], tb.n_in).max()
                    assert reach + tb.width <= L <= tb.n_in + tb.width - 1
