"""K2's launch geometry and K6r's buffers, on the host.

K2 (``csrc/stencil_apply.cu``) takes its whole geometry from
``ops/stencil.py``: the 3D lift, the runs of the raveled (i1, i2) index a
block owns, its x window and its ring of band copies (``k2_plan``).  These
tests hold that plan at every shape ``chip_smoke.py`` launches K2 at, the
2^k and 2^k+1 level shapes and 1D/2D fields: every point is covered once,
idle lanes sit in a block's last warp only, each run's band copy is the
16-byte-aligned superset of the run and fits its ring slot, and shared
memory fits a block (and two blocks an SM at p = 3 f32 on the levels).
``_emulate`` then runs the kernel's data flow in numpy, index for index
(copies into slots read at the run's offset, the x window, the epilogue),
and its SpMV is held against the JAX package's ``spmv_banded_jnp`` (f64,
1e-12: the same terms in the same order) and its RB-GS phase against the
plain version.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``).
"""
import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poms_tpu.ops.spmv import spmv_banded_jnp
from poms_tpu_torch.bench import kernel_probe as kp
from poms_tpu_torch.ops import twofloat
from poms_tpu_torch.ops.stencil import (K2_THREADS, k2_lift, k2_plan,
                                        k2_runs, spmv_banded_plain,
                                        stencil_apply_plain)

torch.set_num_threads(1)


def _chip_smoke_shapes():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(npts, pads) for npts, pads, _, _ in mod.K2_SHAPES]


LEVELS = [((n,) * 3, (3,) * 3) for n in (129, 65, 33, 17, 9, 128, 64, 32,
                                         16, 8)]
SHAPES = _chip_smoke_shapes() + LEVELS + [
    ((1000,), (3,)), ((100,), (2,)), ((33, 33), (3, 3)),
    ((7, 300), (2, 3)), ((4, 3, 260), (1, 1, 2)), ((20, 45, 71), (1, 2, 3))]
DTYPES = [torch.float32, torch.float64, torch.bfloat16]
SMEM_BLOCK, SMEM_SM = 232448, 233472   # an H100's, per block and per SM


def _ids(shapes):
    return ["x".join(map(str, n)) + "p" + "".join(map(str, p))
            for n, p in shapes]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("npts,pads", SHAPES, ids=_ids(SHAPES))
def test_k2_runs_cover_every_point_once(npts, pads, dtype):
    n3, p3, _ = k2_lift(npts, pads)
    plan = k2_plan(n3, p3, dtype)
    n0, n1, n2 = n3
    hits = np.zeros((n0, n1 * n2), dtype=np.int64)
    blocks = 0
    for i0, rows, q0, length in k2_runs(n3, plan):
        blocks += 1
        assert 1 <= rows <= plan["t0"] and 1 <= length <= plan["rl"]
        assert plan["rl"] <= K2_THREADS == 256
        # idle lanes in the last warp of each group of threads only
        per_group = (plan["threads"] - 32) // plan["groups"]   # + a copier
        assert plan["t0"] % plan["groups"] == 0
        assert per_group % 32 == 0 and per_group - length <= 32
        hits[i0:i0 + rows, q0:q0 + length] += 1
        j_first, j_last = q0 // n2, (q0 + length - 1) // n2
        if plan["m2"]:        # a run along one row
            assert j_first == j_last and length + 2 * p3[2] <= plan["wc"]
        else:                 # rows of the padded field, whole
            assert j_last - j_first + 1 + 2 * p3[1] <= plan["wj"]
            assert plan["wc"] == n2 + 2 * p3[2]
    assert blocks == plan["grid"][0] * plan["grid"][1]
    assert (hits == 1).all()
    if n2 < K2_THREADS:      # a plane's runs differ in length by one at most
        lens = [length for i0, _, _, length in k2_runs(n3, plan) if i0 == 0]
        assert max(lens) - min(lens) <= 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("npts,pads", SHAPES, ids=_ids(SHAPES))
def test_k2_shared_memory_fits(npts, pads, dtype):
    n3, p3, _ = k2_lift(npts, pads)
    plan = k2_plan(n3, p3, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert plan["vec"] * item == 16 and plan["rp"] % plan["vec"] == 0
    assert plan["ring"] % 16 == 0      # the window starts 16-byte aligned
    assert plan["smem"] <= SMEM_BLOCK
    if (npts, pads) in LEVELS and dtype != torch.float64:
        # four planes a block on the finest levels (129^3, 128^3), one on
        # the others
        assert plan["t0"] == (4 if npts[0] >= 128 else 1)
        assert 2 * (plan["smem"] + 1024) <= SMEM_SM, plan   # two blocks an SM


def test_k2_two_blocks_an_sm_at_129():
    plan = k2_plan((129,) * 3, (3,) * 3, torch.float32)
    assert (plan["runs"], plan["rl"], plan["threads"]) == (66, 253, 544)
    assert plan["smem"] == 106840 and plan["depth"] == 2


def _emulate(band, x_pad, npts, pads, dtype, mode="spmv", b=None,
             omega=None, color=0, pbase=0):
    """csrc/stencil_apply.cu's data flow in numpy (f64 arithmetic), block
    by block, with the plan's geometry for ``dtype``: each band copy is
    checked to be the aligned superset of its run inside the band's aligned
    extent and to fit its slot; each x window value is checked against
    x_pad at the place the thread means."""
    n3, p3, axes = k2_lift(npts, pads)
    plan = k2_plan(n3, p3, dtype)
    n0, n1, n2 = n3
    p0, p1, p2 = p3
    w0, w1, w2 = (2 * p + 1 for p in p3)
    P0, P1, P2 = (n + 2 * p for n, p in zip(n3, p3))
    M, vec, rp, t0 = n1 * n2, plan["vec"], plan["rp"], plan["t0"]
    N = n0 * M
    wj, wc = plan["wj"], plan["wc"]
    flat = band.reshape(-1)
    extent = -(-flat.size // vec) * vec
    flat = np.concatenate([flat, np.full(extent - flat.size, np.nan)])
    xv = x_pad.reshape(P0, P1, P2)
    bv = None if b is None else b.reshape(n0, M)
    out = np.full(n0 * M, np.nan)
    for by, r in itertools.product(range(plan["grid"][1]),
                                   range(plan["grid"][0])):
        i0 = by * t0
        rows = min(t0, n0 - i0)
        if plan["m2"] == 0:
            base, rem = divmod(M, plan["runs"])
            q0, length = r * base + min(r, rem), base + (r < rem)
        else:
            j, c = divmod(r, plan["m2"])
            base, rem = divmod(n2, plan["m2"])
            q0, length = j * n2 + c * base + min(c, rem), base + (c < rem)
        j_first = q0 // n2
        c_lo = 0 if plan["m2"] == 0 else q0 - j_first * n2
        window = np.zeros(((t0 + 2 * p0) * wj, wc))
        for row in range(window.shape[0]):
            q, jj = divmod(row, wj)
            gq, gj = i0 + q, j_first + jj
            cols = np.arange(wc)
            ok = (gq < P0) & (gj < P1) & (c_lo + cols < P2)
            if gq < P0 and gj < P1:
                window[row, ok] = xv[gq, gj, c_lo + cols[ok]]
        window = window.reshape(-1)
        t = np.arange(length)
        qt = q0 + t
        gj, gl = qt // n2, qt % n2
        xbase = (gj - j_first) * wc + (gl - c_lo)
        acc = np.zeros((rows, length))
        n_mod = N % vec
        for s in range(w0 * w1):
            k0, k1 = divmod(s, w1)
            for k2 in range(w2):
                for i in range(rows):
                    e = (s * w2 + k2) * N + (i0 + i) * M + q0
                    a = e - e % vec
                    elems = -(-(e - a + length) // vec) * vec
                    assert elems <= rp and a + elems <= extent
                    slot = flat[a:a + elems]
                    off = ((s * w2 + k2) * n_mod
                           + ((i0 + i) * M + q0) % vec) % vec
                    assert off == e - a
                    xi = (i + k0) * wj * wc + k1 * wc + k2 + xbase
                    assert xi.min() >= 0 and xi.max() < window.size
                    want_x = xv[i0 + i + k0, gj + k1, gl + k2]
                    assert np.array_equal(window[xi], want_x)
                    acc[i] += slot[off + t] * window[xi]
        for i in range(rows):
            gi = i0 + i
            y = acc[i]
            if mode == "rbgs":
                xc = window[(i + p0) * wj * wc + p1 * wc + p2 + xbase]
                centre = (p0 * w1 + p1) * w2 + p2
                d = flat[centre * N + gi * M + qt]
                on = (pbase + gi + gj + gl) % 2 == color
                y = np.where(on, (1 - omega) * xc
                             + omega * ((bv[gi, qt] - (y - d * xc)) / d), xc)
            out[gi * M + qt] = y
    assert not np.isnan(out).any()
    return out.reshape(npts)


EMULATED = [((6, 9, 35), (1, 1, 1)), ((5, 10, 40), (3, 3, 3)),
            ((9, 13, 70), (1, 2, 1)), ((4, 3, 260), (1, 1, 2)),
            ((7, 300), (2, 3)), ((37, 45), (2, 3)), ((600,), (3,)),
            ((100,), (2,))]


def _operands(npts, pads, seed):
    rng = np.random.default_rng(seed)
    band = rng.standard_normal(tuple(2 * p + 1 for p in pads)
                               + tuple(npts)) / 8
    band[tuple(pads)] += 4.0
    x_pad = rng.standard_normal(tuple(n + 2 * p for n, p in zip(npts, pads)))
    return band, x_pad


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("npts,pads", EMULATED, ids=_ids(EMULATED))
def test_k2_data_flow_is_the_jax_spmv(npts, pads, dtype):
    band, x_pad = _operands(npts, pads, seed=sum(npts))
    got = _emulate(band, x_pad, npts, pads, dtype)
    want = np.asarray(spmv_banded_jnp(jnp.asarray(band), jnp.asarray(x_pad),
                                      npts, pads))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("npts,pads", EMULATED, ids=_ids(EMULATED))
def test_k2_data_flow_rbgs_is_the_plain_phase(npts, pads):
    band, x_pad = _operands(npts, pads, seed=3 + sum(npts))
    b = np.random.default_rng(7).standard_normal(npts)
    starts = (1,) + (0,) * (len(npts) - 1)
    got = _emulate(band, x_pad, npts, pads, torch.float32, mode="rbgs", b=b,
                   omega=0.8, color=1, pbase=sum(starts))
    want = stencil_apply_plain("rbgs", torch.from_numpy(band),
                               torch.from_numpy(x_pad), npts, pads,
                               b=torch.from_numpy(b), omega=0.8, color=1,
                               starts=starts)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)


PROBED = [((6, 9, 35), 1), ((8, 16, 64), 2), ((5, 10, 40), 3),
          ((4, 3, 300), 1)]


@pytest.mark.parametrize("npts,p", PROBED)
def test_probe_plain_full_is_the_spmv_and_compute_pins_block_0(npts, p):
    rng = np.random.default_rng(p)
    band = torch.from_numpy(rng.standard_normal((2 * p + 1,) * 3 + npts))
    x_pad = torch.from_numpy(rng.standard_normal(
        tuple(n + 2 * p for n in npts)))
    pads = (p,) * 3
    assert torch.equal(kp.stencil_probe_plain("full", band, x_pad, npts,
                                              pads),
                       spmv_banded_plain(band, x_pad, npts, pads))
    pin0, pinq = kp.k2_pinned(npts)
    plan = k2_plan(npts, pads, torch.float32, t0=kp.K2_PROBE_T0)
    assert plan["t0"] == kp.K2_PROBE_T0
    run0 = next(k2_runs(npts, plan))
    assert int(pin0.max()) < kp.K2_PROBE_T0 and int(pinq.max()) < run0[3]
    # each point reads the band where block (0, 0) holds its place
    for i0, rows, q0, length in k2_runs(npts, plan):
        assert torch.equal(pinq[q0:q0 + length], torch.arange(length))


def test_k6r_buffers_are_made_once_per_device():
    dev = torch.device("cpu")
    part, counter = twofloat.reduce_scratch(dev)
    again = twofloat.reduce_scratch(dev)
    assert again[0] is part and again[1] is counter
    assert part.dtype == torch.float32 and counter.dtype == torch.int32
    assert part.numel() == 2 * twofloat.MAX_DOTS * twofloat.REDUCE_MAX_BLOCKS
    assert counter.numel() == 1 and int(counter) == 0


def test_k2_lift_keeps_band_and_field_layouts():
    """A lifted view is the same memory: the 2D (n1, 1, n2) lift of long
    rows and the (1, n1, n2) lift of short ones."""
    for npts, pads in (((7, 300), (2, 3)), ((37, 45), (2, 3)), ((9,), (1,))):
        n3, p3, axes = k2_lift(npts, pads)
        band, x_pad = _operands(npts, pads, seed=1)
        b3 = band.reshape(tuple(2 * p + 1 for p in p3) + n3)
        x3 = x_pad.reshape(tuple(n + 2 * p for n, p in zip(n3, p3)))
        got = spmv_banded_plain(torch.from_numpy(b3), torch.from_numpy(x3),
                                n3, p3).reshape(npts)
        want = spmv_banded_plain(torch.from_numpy(band),
                                 torch.from_numpy(x_pad), npts, pads)
        assert torch.equal(got, want)
        assert [a for a in axes if a is not None] == list(range(len(npts)))
        assert all(n3[a] == 1 and p3[a] == 0
                   for a in range(3) if axes[a] is None)
