"""The v2 banded engine (K3) on the CPU against the JAX package's.

The port's ``pack_band_v2`` followed by ``stencil_apply_v2_plain`` against
the JAX package's v2 Pallas engine (``POMS_TPU_SPMV=v2``) run in interpret
mode, at the non-slow shapes of ``tests/test_pallas.py``; tolerances are
that file's: rtol = atol = 1e-5, and 3e-5 / 3e-6 for Jacobi and RB-GS
(the Pallas engine sums in its own chunk order).  The port's pack is not
bitwise the JAX ``blk`` (its tiles are the H100 kernel's), so only the
results are compared; the port's unpack∘pack round trip is bitwise.  Then
the plumbing (engine selection, packing once per operator, packed apply
equal to unpacked) and the slice end to end: the 16³ p3 banded f64-mixed
PCG under v2 against the JAX reference.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu.ops.pallas import spmv as ref_pallas
from poms_tpu_torch import convert
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.hierarchy import build_hierarchy
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import dispatch, stencil_v2
from poms_tpu_torch.ops.stencil import stencil_apply
from poms_tpu_torch.ops.stencil_v2 import (pack_band_v2, stencil_apply_v2,
                                           stencil_apply_v2_plain, tile_v2,
                                           unpack_band_v2)

torch.set_num_threads(1)

CASES = [((8, 12, 20), 1), ((10, 9, 130), 2), ((16, 24), 2), ((40, 140), 3),
         ((600,), 2)]


@pytest.fixture(params=["v1", "v2"])
def engine(request, monkeypatch):
    monkeypatch.setenv("POMS_TPU_SPMV", request.param)
    return request.param


@pytest.fixture
def v2(monkeypatch):
    monkeypatch.setenv("POMS_TPU_SPMV", "v2")


def _setup(npts, p, seed):
    """tests/test_pallas.py's operands, from numpy: a normalised random
    band (diagonal shifted by 5 for the smoothers), x_pad and b."""
    d = len(npts)
    rng = np.random.default_rng(seed)
    terms = (2 * p + 1) ** d
    band = (rng.standard_normal(tuple(2 * p + 1 for _ in range(d)) + npts)
            / (2.0 * np.sqrt(terms))).astype(np.float32)
    band[(p,) * d] += 5.0
    x_pad = rng.standard_normal(tuple(n + 2 * p for n in npts)
                                ).astype(np.float32)
    b = rng.standard_normal(npts).astype(np.float32)
    return band, x_pad, b


def _port(mode, band, x_pad, b, npts, p, **kw):
    pads = (p,) * len(npts)
    packed = pack_band_v2(torch.from_numpy(band), npts, pads)
    out = stencil_apply_v2_plain(
        mode, packed, torch.from_numpy(x_pad), npts, pads,
        None if b is None else torch.from_numpy(b), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("npts,p", CASES)
def test_spmv_matches_jax_v2(v2, npts, p):
    band, x_pad, _ = _setup(npts, p, seed=0)
    want = ref_pallas.spmv_banded_pallas(jnp.asarray(band),
                                         jnp.asarray(x_pad), npts,
                                         (p,) * len(npts), interpret=True)
    np.testing.assert_allclose(_port("spmv", band, x_pad, None, npts, p),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("npts,p", CASES)
def test_residual_matches_jax_v2(v2, npts, p):
    band, x_pad, b = _setup(npts, p, seed=1)
    want = ref_pallas.residual_fused_pallas(
        jnp.asarray(band), jnp.asarray(x_pad), jnp.asarray(b), npts,
        (p,) * len(npts), interpret=True)
    np.testing.assert_allclose(_port("residual", band, x_pad, b, npts, p),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("npts,p", CASES)
def test_jacobi_matches_jax_v2(v2, npts, p):
    band, x_pad, b = _setup(npts, p, seed=2)
    want = ref_pallas.jacobi_fused_pallas(
        jnp.asarray(band), jnp.asarray(x_pad), jnp.asarray(b), 0.7, npts,
        (p,) * len(npts), interpret=True)
    got = _port("jacobi", band, x_pad, b, npts, p, omega=0.7)
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("npts,p", CASES)
@pytest.mark.parametrize("starts_off", [0, 1])
@pytest.mark.parametrize("color", [0, 1])
def test_rbgs_color_matches_jax_v2(v2, npts, p, starts_off, color):
    band, x_pad, b = _setup(npts, p, seed=3)
    starts = (starts_off,) * len(npts)
    want = ref_pallas.rbgs_color_pallas(
        jnp.asarray(band), jnp.asarray(x_pad), jnp.asarray(b), 0.9, color,
        npts, (p,) * len(npts), starts=starts, interpret=True)
    got = _port("rbgs", band, x_pad, b, npts, p, omega=0.9, color=color,
                starts=starts)
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("npts,pads", [
    ((8, 12, 20), (1, 1, 1)), ((10, 9, 130), (2, 2, 2)),
    ((9, 17, 33), (3, 3, 3)), ((5, 8, 70), (1, 2, 0)), ((16, 24), (2, 2)),
    ((40, 140), (3, 1)), ((600,), (2,)), ((5,), (1,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unpack_pack_round_trip_is_bitwise(npts, pads, dtype):
    rng = np.random.default_rng(len(npts))
    band = torch.as_tensor(rng.standard_normal(
        tuple(2 * p + 1 for p in pads) + npts), dtype=dtype)
    packed = pack_band_v2(band, npts, pads)
    assert packed["blk"].dtype == dtype
    assert torch.equal(unpack_band_v2(packed), band)
    assert torch.equal(packed["diag"], band[pads])
    # only the lane axis is rounded, to 16 bytes: no padded tiles
    lift = (1,) * (3 - len(npts)) + npts
    assert packed["N"][:2] == lift[:2]
    assert packed["N"][2] - lift[2] < 16 // band.element_size()
    assert packed["tile"] == tile_v2(lift, dtype)


def _slabs(packed, band6):
    """Read every (tile, k0, k1) slab at the offsets the CUDA kernel
    computes (csrc/stencil_apply_v2.cu) and check it against the band."""
    blk = packed["blk"].numpy()
    n0, n1, n2p = packed["N"]
    n2 = band6.shape[5]
    T0, T1, T2 = packed["tile"]
    w0, w1, w2 = band6.shape[:3]
    W = w0 * w1 * w2
    for i0, j0, l0 in itertools.product(range(0, n0, T0), range(0, n1, T1),
                                        range(0, n2, T2)):
        e0, e1, e2 = min(T0, n0 - i0), min(T1, n1 - j0), min(T2, n2 - l0)
        r2 = min(T2, n2p - l0)
        slab = w2 * e0 * e1 * r2
        base = W * (i0 * n1 * n2p + e0 * (j0 * n2p + e1 * l0))
        assert base % (16 // blk.itemsize) == 0 and slab * blk.itemsize % 16 == 0
        for k0, k1 in itertools.product(range(w0), range(w1)):
            s = blk[base + (k0 * w1 + k1) * slab:][:slab]
            s = s.reshape(w2, e0, e1, r2)
            np.testing.assert_array_equal(
                s[..., :e2], band6[k0, k1, :, i0:i0 + e0, j0:j0 + e1,
                                   l0:l0 + e2])
            assert not s[..., e2:].any()


@pytest.mark.parametrize("npts,pads,dtype", [
    ((9, 17, 33), (3, 3, 3), torch.float32),
    ((5, 10, 70), (1, 2, 1), torch.float64),
    ((20, 37), (2, 3), torch.float32), ((300,), (3,), torch.float64)])
def test_pack_layout_is_the_kernels(npts, pads, dtype):
    """The kernel finds each slab by a closed-form offset; the pack must
    put the band there, 16-byte aligned, ragged tiles compact."""
    rng = np.random.default_rng(7)
    band = torch.as_tensor(rng.standard_normal(
        tuple(2 * p + 1 for p in pads) + npts), dtype=dtype)
    packed = pack_band_v2(band, npts, pads)
    lead = (1,) * (3 - len(npts))
    band6 = band.numpy().reshape(lead + band.shape[:len(npts)] + lead
                                 + band.shape[len(npts):])
    _slabs(packed, band6)


def test_engine_selects_v2(engine):
    """``POMS_TPU_SPMV=v2`` selects K3, anything else K2 (the JAX
    package's ``_engine`` rule), and the JAX package agrees."""
    want = stencil_apply_v2 if engine == "v2" else stencil_apply
    assert dispatch.engine() is want
    ref = (ref_pallas._stencil_call_v2 if engine == "v2"
           else ref_pallas._stencil_call)
    assert ref_pallas._engine() is ref


def test_stencil_matrix_v2_pack_plumbing(monkeypatch):
    """ensure_packed_v2 packs once at setup (and not under v1), the pack
    is pack_band_v2's, and the packed apply equals the unpacked one and
    the v1 engine's, bitwise."""
    npts, p = (8, 12, 20), 1
    rng = np.random.default_rng(5)
    sp = StencilVectorSpace(npts=npts, pads=(p,) * 3, periodic=(False,) * 3,
                            dtype=torch.float32, device="cpu")
    band_t = torch.as_tensor(rng.standard_normal((3, 3, 3) + npts),
                             dtype=torch.float32)
    A = StencilMatrix(sp, band_t=band_t)
    monkeypatch.setenv("POMS_TPU_SPMV", "v1")
    assert A.ensure_packed_v2().packed_v2 is None
    x = StencilVector.from_interior(sp, torch.as_tensor(
        rng.standard_normal(npts), dtype=torch.float32))
    y_v1 = A.dot(x).interior
    monkeypatch.setenv("POMS_TPU_SPMV", "v2")
    assert A.packed_v2 is None
    pk = A.ensure_packed_v2().packed_v2
    ref = pack_band_v2(band_t, npts, (p,) * 3)
    assert pk["tile"] == ref["tile"] and pk["N"] == ref["N"]
    assert torch.equal(pk["blk"], ref["blk"])
    assert A.ensure_packed_v2().packed_v2 is pk      # once
    x_pad = x.update_ghost_regions().data
    unpacked = stencil_apply_v2("spmv", band_t, x_pad, npts, (p,) * 3)
    packed = stencil_apply_v2("spmv", None, x_pad, npts, (p,) * 3,
                              packed=pk)
    assert torch.equal(unpacked, packed)
    assert torch.equal(A.dot(x).interior, y_v1)


def test_v2_refuses_a_foreign_pack():
    npts, pads = (8, 12, 20), (1, 1, 1)
    band = torch.zeros((3, 3, 3) + npts)
    pk = pack_band_v2(band, npts, pads)
    x_pad = torch.zeros((9, 14, 22))
    with pytest.raises(ValueError, match="packed band was built"):
        stencil_apply_v2("spmv", None, x_pad, (7, 12, 20), pads, packed=pk)
    with pytest.raises(ValueError, match="needs band_t or packed"):
        stencil_apply_v2("spmv", None, x_pad[1:], (7, 12, 20), pads)
    with pytest.raises(ValueError, match="band_t has shape"):
        pack_band_v2(band, (8, 12, 21), pads)


def test_hierarchy_packs_every_banded_level(v2):
    prob = poisson_problem(3, 8, degree=2, device="cpu")
    levels = build_hierarchy(prob, 2)
    assert levels[0].A is prob.A
    for lev in levels:
        pk = lev.A.packed_v2
        assert pk is not None and pk["npts"] == lev.A.space.npts
        assert pk["blk"].dtype == lev.A.band_t.dtype


def test_banded_f64_mixed_pcg_v2_matches_jax(v2, monkeypatch):
    """The slice under the v2 engine on the CPU (K3's plain version from
    each level's pack): the 16³ p3 banded f64-mixed PCG, 2 levels, against
    the JAX reference run eagerly, with the reference's λs: equal
    iterations, histories within 1e-3 through iteration 3 and 5e-2 after
    (the bounds of tests/test_torch_pcg.py's banded test and its reasons:
    the f32 coarse triangular solves round differently)."""
    calls = []
    plain = stencil_v2.stencil_apply_v2_plain

    def counted(mode, *a, **kw):
        calls.append(mode)
        return plain(mode, *a, **kw)

    monkeypatch.setattr(stencil_v2, "stencil_apply_v2_plain", counted)
    cyc = dict(nu1=1, nu2=1)
    with jax.disable_jit():
        rp = ref_problem(3, 16, degree=3)
        ref = RefPCG(rp, 2, RefCycle(**cyc, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0)), mixed=True, precision="f64")
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=1e-10, maxiter=30)
    pp = poisson_problem(3, 16, degree=3, device="cpu")
    port = MGPreconditionedCG(pp, 2, CycleConfig(
        **cyc, smoother=SmootherConfig("chebyshev", cheb_fraction=16.0)),
        mixed=True, precision="f64")
    for levels in (port.levels, port.levels_pre):
        assert all(lev.A.packed_v2 is not None for lev in levels)
    port.lams = convert.lams(lams)
    pres = port.solve(tol=1e-10, maxiter=30)
    assert {"spmv", "residual"} <= set(calls)
    assert rres.converged and pres.converged
    assert pres.iterations == rres.iterations, (pres.iterations,
                                                rres.iterations)
    for i, (a, b) in enumerate(zip(pres.residuals, rres.residuals)):
        tol = 1e-3 if i <= 3 else 5e-2
        assert abs(a - b) <= tol * b, (i, a, b)
    r = pp.b.interior - pp.A.dot(pres.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
    want = np.asarray(rres.x.interior)
    assert want.dtype == np.float64
    assert (np.abs(pres.x.interior.numpy() - want).max()
            <= 1e-6 * np.abs(want).max())
