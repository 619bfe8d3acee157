"""The port's hierarchy, smoothers and cycles against ``poms_tpu.mg``.

Hierarchies are built from bitwise-equal host code, so the 1D bands and the
transfer bands must be bitwise equal; the Cholesky factors come from two
LAPACK-style factorizations (≤ 1e-12).  Cycles run on the same state (the
reference levels carried over with ``poms_tpu_torch.convert``) and with the
reference's λ estimates, which the port cannot redraw: the reference's power
iteration starts from ``jax.random``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.mg import cycles as ref_cycles
from poms_tpu.mg.hierarchy import build_hierarchy as ref_build
from poms_tpu.mg.mixed import _cast_levels as ref_cast
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu_torch import convert
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg import cycles
from poms_tpu_torch.mg.hierarchy import build_hierarchy
from poms_tpu_torch.mg.mixed import _cast_levels
from poms_tpu_torch.mg.smoother import (SmootherConfig,
                                        attach_spectral_estimates,
                                        estimate_dinv_a_lambda_max)
from poms_tpu_torch.models.poisson import poisson_problem

torch.set_num_threads(1)


def _f64(a):
    a = np.asarray(a)
    assert a.dtype == np.float64, a.dtype
    return a


@pytest.fixture(scope="module")
def ref16():
    """3D n_el=16 p=3, 3 levels: the reference hierarchy and its λs."""
    rp = ref_problem(3, 16, degree=3, operator="kron")
    rl = ref_build(rp, 3, operator="kron")
    cheb = RefSmoother("chebyshev", cheb_fraction=16.0)
    return rp, rl, ref_lams(rl, cheb)


@pytest.mark.parametrize("n_el,levels", [(8, 2), (16, 3)])
def test_hierarchy_bitwise(n_el, levels):
    rp = ref_problem(3, n_el, degree=3, operator="kron")
    rl = ref_build(rp, levels, operator="kron")
    pp = poisson_problem(3, n_el, degree=3)
    pl = build_hierarchy(pp, levels)
    np.testing.assert_array_equal(pp.b.interior.numpy(), _f64(rp.b.interior))
    assert len(pl) == len(rl)
    for plev, rlev in zip(pl, rl):
        assert plev.A.space.npts == rlev.A.space.npts
        assert plev.A._band_labels() == rlev.A._band_labels()
        for pt, rt in zip(plev.A.terms, rlev.A.terms):
            for Bp, Br in zip(pt, rt):
                np.testing.assert_array_equal(Bp.numpy(), _f64(Br))
        for kind in ("restrict", "prolong"):
            rtb, ptb = getattr(rlev, kind), getattr(plev, kind)
            assert (rtb is None) == (ptb is None)
            for p_tb, r_tb in zip(ptb or (), rtb or ()):
                np.testing.assert_array_equal(p_tb.w.numpy(), _f64(r_tb.w))
                np.testing.assert_array_equal(p_tb.c0.numpy(),
                                              np.asarray(r_tb.c0))
                assert p_tb.n_in == r_tb.n_in
    L = _f64(rl[-1].chol.L)
    assert np.abs(pl[-1].chol.L.numpy() - L).max() <= 1e-12 * np.abs(L).max()


def _cycle_pair(ref16, cfg_kw, dtype, gamma=1, seed=0):
    """One cycle from x = 0 on a random RHS in both packages."""
    rp, rl, lams = ref16
    jdt, tdt = {32: (jnp.float32, torch.float32),
                64: (jnp.float64, torch.float64)}[dtype]
    rlv = ref_cast(rl, jdt) if dtype == 32 else rl
    plv = convert.levels(rlv)
    kind = cfg_kw.get("kind", "chebyshev")
    rcfg = ref_cycles.CycleConfig(nu1=1, nu2=1, gamma=gamma,
                                  smoother=RefSmoother(**cfg_kw))
    pcfg = cycles.CycleConfig(nu1=1, nu2=1, gamma=gamma,
                              smoother=SmootherConfig(**cfg_kw))
    b = np.random.default_rng(seed).standard_normal(rp.space.npts)
    rsp, psp = rlv[0].A.space, plv[0].A.space
    assert psp.dtype == tdt
    rb = RefVec.from_interior(rsp, jnp.asarray(b, jdt))
    pb = StencilVector.from_interior(psp, torch.as_tensor(b, dtype=tdt))
    ll = lams if kind == "chebyshev" else None
    want = ref_cycles.cycle(rlv, 0, RefVec.zeros(rsp), rb, rcfg, ll)
    got = cycles.cycle(plv, 0, StencilVector.zeros(psp), pb, pcfg,
                       convert.lams(ll) if ll else None)
    return got.interior.numpy(), np.asarray(want.interior), rlv, plv, rb, pb


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("gamma", [1, 2])
def test_cycle_f32_matches_jax(ref16, gamma):
    """V- and W-cycle, Chebyshev(4) over λmax/16, in f32: ≤ 1e-5."""
    got, want, *_ = _cycle_pair(ref16, dict(kind="chebyshev",
                                             cheb_fraction=16.0), 32, gamma)
    assert want.dtype == np.float32
    assert _rel(got, want) <= 1e-5


def test_cycle_f64_jacobi_matches_jax(ref16):
    """The generic-operator Jacobi branch, f64: ≤ 1e-12."""
    got, want, *_ = _cycle_pair(ref16, dict(kind="jacobi", omega=0.3), 64)
    assert _rel(got, _f64(want)) <= 1e-12


def test_fmg_matches_jax(ref16):
    rp, rl, lams = ref16
    cfg_kw = dict(kind="chebyshev", cheb_fraction=16.0)
    _, _, rlv, plv, rb, pb = _cycle_pair(ref16, cfg_kw, 64)
    want = ref_cycles.fmg(rlv, rb, ref_cycles.CycleConfig(
        nu1=1, nu2=1, smoother=RefSmoother(**cfg_kw)), lams=lams)
    got = cycles.fmg(plv, pb, cycles.CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig(**cfg_kw)),
        lams=convert.lams(lams))
    assert _rel(got.interior.numpy(), _f64(want.interior)) <= 1e-12


def test_lambda_estimate_within_2_percent(ref16):
    """The port's own f32 power iteration (torch.Generator start vector)
    against the reference's (jax.random start vector)."""
    _, rl, lams = ref16
    pl = convert.levels(rl)
    ours = attach_spectral_estimates(
        pl, SmootherConfig("chebyshev", cheb_fraction=16.0))
    assert ours[-1] is None and lams[-1] is None
    for a, b in zip(ours[:-1], lams[:-1]):
        assert abs(a - b) / b <= 0.02, (a, b)
    assert abs(estimate_dinv_a_lambda_max(pl[0].A, seed=5) * 1.02
               - lams[0]) / lams[0] <= 0.02


def test_cast_levels_keeps_sharing(ref16):
    _, rl, _ = ref16
    pl = convert.levels(rl)
    lo = _cast_levels(pl, torch.float32)
    for plev, llev in zip(pl, lo):
        assert llev.A.space.dtype == torch.float32
        assert llev.A._band_labels() == plev.A._band_labels()
    assert lo[-1].chol.L.dtype == torch.float32
    assert lo[0].restrict[0].w.dtype == torch.float32
