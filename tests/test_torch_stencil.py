"""The port's ``StencilMatrix`` against ``poms_tpu.core.matrix``.

Construction and host interchange run the same numpy code on the same f64
bands, so they are held bitwise: ``from_coo``, ``tocoo``, ``tocsr``,
``tobsr``, ``toarray``, ``transpose``, ``validate_boundary`` and the
periodic wrap.  The Kronecker-sum ``to_stencil`` composes its band with
another einsum than the JAX package's, so it is held to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poms_tpu.core.matrix import StencilMatrix as RefMatrix
from poms_tpu.core.space import StencilVectorSpace as RefSpace
from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.mg.hierarchy import _kron_operator_from_1d as ref_kron_op
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu_torch import convert
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.hierarchy import _kron_operator_from_1d
from poms_tpu_torch.models.poisson import poisson_problem

torch.set_num_threads(1)

CASES = [((13,), (2,), (False,)), ((16,), (3,), (True,)),
         ((9, 11), (2, 1), (False, False)), ((8, 8), (2, 2), (True, False)),
         ((6, 7, 8), (1, 2, 1), (False, False, False)),
         ((6, 6, 6), (2, 2, 2), (True, True, True))]


def _random_band(npts, pads, periodic, seed):
    """Grid-major random band, zero where a non-periodic row reaches out."""
    rng = np.random.default_rng(seed)
    nd = len(npts)
    band = rng.standard_normal(tuple(npts) + tuple(2 * p + 1 for p in pads))
    for a, (n, p, per) in enumerate(zip(npts, pads, periodic)):
        if per:
            continue
        i = np.arange(n).reshape([-1 if b == a else 1 for b in range(nd)]
                                 + [1] * nd)
        off = np.arange(2 * p + 1).reshape(
            [1] * nd + [-1 if b == a else 1 for b in range(nd)])
        col = i + off - p
        band = np.where((col < 0) | (col >= n), 0.0, band)
    return band


def _pair(npts, pads, periodic, seed=0):
    band = _random_band(npts, pads, periodic, seed)
    ref = RefMatrix.from_band(RefSpace(npts=npts, pads=pads,
                                       periodic=periodic), band)
    ours = StencilMatrix.from_band(
        StencilVectorSpace(npts=npts, pads=pads, periodic=periodic,
                           device="cpu"), band)
    return ref, ours


def _f64(a):
    a = np.asarray(a)
    assert a.dtype == np.float64, a.dtype
    return a


@pytest.mark.parametrize("npts,pads,periodic", CASES)
def test_layout_and_interchange_bitwise(npts, pads, periodic):
    ref, ours = _pair(npts, pads, periodic, seed=42)
    assert ours.band_t.is_contiguous()
    np.testing.assert_array_equal(ours.band_t.numpy(), _f64(ref.band_t))
    np.testing.assert_array_equal(ours.band.numpy(), _f64(ref.band))
    np.testing.assert_array_equal(ours.diagonal().numpy(),
                                  _f64(ref.diagonal()))
    rc, oc = ref.tocoo(), ours.tocoo()
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(oc, f), getattr(rc, f))
    rr, orr = ref.tocsr(), ours.tocsr()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(orr, f), getattr(rr, f))
    np.testing.assert_array_equal(ours.toarray(), ref.toarray())
    np.testing.assert_array_equal(ours.transpose().band_t.numpy(),
                                  _f64(ref.transpose().band_t))
    np.testing.assert_array_equal(ours.T.toarray(), ref.toarray().T)
    assert ours.validate_boundary() and ref.validate_boundary()


@pytest.mark.parametrize("npts,pads,periodic", CASES)
def test_from_coo_roundtrip_bitwise(npts, pads, periodic):
    ref, ours = _pair(npts, pads, periodic, seed=3)
    coo = ref.tocoo()
    back = StencilMatrix.from_coo(ours.space, coo.row, coo.col, coo.data)
    want = RefMatrix.from_coo(ref.space, coo.row, coo.col, coo.data)
    np.testing.assert_array_equal(back.band_t.numpy(), _f64(want.band_t))
    sci = StencilMatrix.from_scipy(ours.space, ref.tocsr())
    np.testing.assert_array_equal(sci.band_t.numpy(), _f64(ref.band_t))


@pytest.mark.parametrize("npts,pads,periodic", CASES[2:4])
def test_tobsr_bitwise(npts, pads, periodic):
    ref, ours = _pair(npts, pads, periodic, seed=9)
    for bs in (None, (4, 4) if np.prod(npts) % 4 == 0 else (1, 1)):
        rb, ob = ref.tobsr(blocksize=bs), ours.tobsr(blocksize=bs)
        assert ob.blocksize == rb.blocksize
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(ob, f), getattr(rb, f))


def test_pads_too_small_and_boundary_checks():
    ref, ours = _pair((9, 11), (2, 1), (False, False), seed=1)
    coo = ref.tocoo()
    small = StencilVectorSpace(npts=(9, 11), pads=(1, 1), device="cpu")
    with pytest.raises(ValueError):
        StencilMatrix.from_coo(small, coo.row, coo.col, coo.data)
    with pytest.raises(ValueError):
        RefMatrix.from_coo(RefSpace(npts=(9, 11), pads=(1, 1)), coo.row,
                           coo.col, coo.data)
    bad = ours.band_t.clone()
    bad[0, 0, 0, 0] = 1.0            # row 0 reaching to column −2
    assert not StencilMatrix(ours.space, band_t=bad).validate_boundary()
    with pytest.raises(ValueError):
        StencilMatrix.from_band(ours.space, bad)   # grid-major shape wanted
    with pytest.raises(ValueError):
        StencilMatrix.from_band_t(small, ours.band_t)


def test_from_coo_tol_drops_junk():
    ref, ours = _pair((8, 8), (1, 1), (False, False), seed=2)
    coo = ref.tocoo()
    rows = np.concatenate([coo.row, [0]])
    cols = np.concatenate([coo.col, [63]])       # far outside the band
    vals = np.concatenate([coo.data, [1e-17]])
    got = StencilMatrix.from_coo(ours.space, rows, cols, vals, tol=1e-15)
    np.testing.assert_array_equal(got.band_t.numpy(), _f64(ref.band_t))


@pytest.mark.parametrize("npts,pads,periodic", CASES)
def test_dot_matches_jax(npts, pads, periodic):
    """dot = ghost refresh (zeros or wrap) + K2's plain spmv: ≤ 1e-13."""
    ref, ours = _pair(npts, pads, periodic, seed=5)
    x = np.random.default_rng(7).standard_normal(npts)
    want = _f64(ref.dot(RefVec.from_interior(ref.space, x)).interior)
    got = ours.dot(StencilVector.from_interior(ours.space,
                                               torch.from_numpy(x)))
    assert np.abs(got.interior.numpy() - want).max() <= 1e-13 * \
        np.abs(want).max()
    np.testing.assert_allclose(got.toarray(), ours.tocsr() @ x.ravel(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("npts,pads,periodic", CASES)
def test_residual_matches_jax(npts, pads, periodic):
    """residual(x, b) = b − A x in one fused pass: ≤ 1e-13 of the JAX
    package's b − A·x."""
    ref, ours = _pair(npts, pads, periodic, seed=8)
    rng = np.random.default_rng(11)
    x, b = rng.standard_normal(npts), rng.standard_normal(npts)
    want = b - _f64(ref.dot(RefVec.from_interior(ref.space, x)).interior)
    got = ours.residual(
        StencilVector.from_interior(ours.space, torch.from_numpy(x)),
        StencilVector.from_interior(ours.space, torch.from_numpy(b)))
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()


def test_kron_residual_matches_banded():
    """The Kronecker-sum operator's residual against the banded one's on
    the same Poisson operator: ≤ 1e-12 relative."""
    pp = poisson_problem(3, 6, degree=3, device="cpu")
    kron = _kron_operator_from_1d([(s.K, s.M) for s in pp.splines],
                                  pp.space)
    x = StencilVector.from_interior(pp.space, torch.from_numpy(
        np.random.default_rng(12).standard_normal(pp.space.npts)))
    want = pp.A.residual(x, pp.b)
    got = kron.residual(x, pp.b)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(got, pp.b.interior - kron.dot(x).interior)


def test_algebra():
    _, ours = _pair((9, 11), (2, 1), (False, False), seed=6)
    twice = ours + ours
    np.testing.assert_array_equal(twice.band_t.numpy(),
                                  (2.0 * ours).band_t.numpy())
    np.testing.assert_array_equal((ours * 3.0).band_t.numpy(),
                                  ours.band_t.numpy() * 3.0)


@pytest.mark.parametrize("dim,n_el,p", [(1, 12, 2), (2, (6, 8), 2),
                                        (3, 6, 3)])
def test_poisson_band_and_to_stencil(dim, n_el, p):
    """The banded Poisson operator (device einsum) and the Kronecker-sum
    operator's ``to_stencil``/``tocsr``/``toarray``, against the JAX
    package's banded operator: ≤ 1e-12 relative."""
    rp = ref_problem(dim, n_el, degree=p)
    pp = poisson_problem(dim, n_el, degree=p, device="cpu")
    want = _f64(rp.A.band_t)
    scale = np.abs(want).max()
    assert np.abs(pp.A.band_t.numpy() - want).max() <= 1e-12 * scale
    kron = _kron_operator_from_1d([(s.K, s.M) for s in pp.splines],
                                  pp.space)
    st = kron.to_stencil()
    assert isinstance(st, StencilMatrix)
    assert np.abs(st.band_t.numpy() - want).max() <= 1e-12 * scale
    ref_st = ref_kron_op([(s.K, s.M) for s in rp.splines],
                         rp.space).to_stencil()
    assert np.abs(st.band_t.numpy() - _f64(ref_st.band_t)).max() \
        <= 1e-12 * scale
    dense = rp.A.toarray()
    assert np.abs(kron.toarray() - dense).max() <= 1e-12 * scale
    assert np.abs(kron.tocsr().toarray() - dense).max() <= 1e-12 * scale
    np.testing.assert_array_equal(pp.b.interior.numpy(),
                                  _f64(rp.b.interior))


def test_convert_stencil_matrix():
    rp = ref_problem(2, 8, degree=2)
    A = convert.stencil_matrix(rp.A)
    assert isinstance(A, StencilMatrix) and A.band_t.dtype == torch.float64
    np.testing.assert_array_equal(A.band_t.numpy(), _f64(rp.A.band_t))
    prob = convert.problem(rp)
    assert isinstance(prob.A, StencilMatrix)
    np.testing.assert_array_equal(prob.b.interior.numpy(),
                                  _f64(rp.b.interior))
    assert jnp.asarray(rp.A.band_t).dtype == jnp.float64
