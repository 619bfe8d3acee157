"""The port's host sparse copies (``poms_tpu_torch.sparse``) against
``poms_tpu.sparse``: the same numpy code on the same inputs, so every
result is bitwise equal in f64."""
import numpy as np
import pytest
import scipy.sparse as sps

from poms_tpu.sparse.bsr import BsrMatrix as RefBsr
from poms_tpu.sparse.csr import CsrMatrix as RefCsr
from poms_tpu.sparse.native import native_available as ref_native
from poms_tpu.sparse.spgemm import csr_spgemm as ref_spgemm
from poms_tpu.sparse.spgemm import rap as ref_rap
from poms_tpu_torch.sparse import native
from poms_tpu_torch.sparse.bsr import BsrMatrix
from poms_tpu_torch.sparse.csr import CsrMatrix
from poms_tpu_torch.sparse.spgemm import csr_spgemm, rap


def _rand_sparse(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return sps.random(m, n, density=density, random_state=rng, format="csr")


def _same_csr(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype == np.float64
    assert tuple(a.shape) == tuple(b.shape)


def test_csr_from_coo_spmv_transpose_bitwise():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 20, 120)
    cols = rng.integers(0, 15, 120)
    vals = rng.standard_normal(120)
    ours = CsrMatrix.from_coo(rows, cols, vals, (20, 15))
    ref = RefCsr.from_coo(rows, cols, vals, (20, 15))
    _same_csr(ours, ref)
    _same_csr(ours.transpose(), ref.transpose())
    x = rng.standard_normal(15)
    np.testing.assert_array_equal(ours.spmv(x), ref.spmv(x))


@pytest.mark.parametrize("m,k,n,da,db", [(20, 30, 25, 0.2, 0.15),
                                         (50, 50, 50, 0.05, 0.05),
                                         (7, 7, 7, 0.0, 0.3)])
def test_spgemm_bitwise(m, k, n, da, db):
    A = _rand_sparse(m, k, da, 1)
    B = _rand_sparse(k, n, db, 2)
    ours = csr_spgemm(CsrMatrix.from_scipy(A), CsrMatrix.from_scipy(B))
    ref = ref_spgemm(RefCsr.from_scipy(A), RefCsr.from_scipy(B))
    _same_csr(ours, ref)
    np.testing.assert_allclose(ours.to_scipy().toarray(), (A @ B).toarray(),
                               atol=1e-13)


def test_rap_bitwise():
    A = _rand_sparse(40, 40, 0.1, 3)
    P = _rand_sparse(40, 18, 0.2, 4)
    ours = rap(CsrMatrix.from_scipy(P.T.tocsr()), CsrMatrix.from_scipy(A),
               CsrMatrix.from_scipy(P))
    ref = ref_rap(RefCsr.from_scipy(P.T.tocsr()), RefCsr.from_scipy(A),
                  RefCsr.from_scipy(P))
    _same_csr(ours, ref)


def test_native_builds_outside_the_package():
    """g++ builds into poms_tpu_torch/_build/, never next to the source."""
    if not (native.native_available() and ref_native()):
        pytest.skip("no g++ here: csr_spgemm takes its numpy path")
    path = native._build()
    assert path.parent.name == "_build" and path.exists()
    assert not list(native._SRC.parent.glob("*.so"))


def test_numpy_path_matches_native(monkeypatch):
    """Without g++, csr_spgemm's numpy expand/coalesce path gives the same
    matrix (same structure; values to rounding: another summation order)."""
    A = _rand_sparse(30, 30, 0.2, 9)
    B = _rand_sparse(30, 30, 0.2, 10)
    fast = csr_spgemm(CsrMatrix.from_scipy(A), CsrMatrix.from_scipy(B))
    monkeypatch.setattr(native, "native_available", lambda: False)
    slow = csr_spgemm(CsrMatrix.from_scipy(A), CsrMatrix.from_scipy(B))
    np.testing.assert_array_equal(slow.indptr, fast.indptr)
    np.testing.assert_array_equal(slow.indices, fast.indices)
    np.testing.assert_allclose(slow.data, fast.data, rtol=1e-14, atol=0)


def test_bsr_bitwise():
    rng = np.random.default_rng(3)
    n, bs = 24, 4
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    coo = sps.coo_matrix(dense)
    ours = BsrMatrix.from_coo(coo.row, coo.col, coo.data, (n, n), (bs, bs))
    ref = RefBsr.from_coo(coo.row, coo.col, coo.data, (n, n), (bs, bs))
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    x = rng.standard_normal(n)
    np.testing.assert_array_equal(ours.spmv(x), ref.spmv(x))
    np.testing.assert_array_equal(ours.toarray(), dense)
    back = BsrMatrix.from_scipy(ours.to_scipy())
    np.testing.assert_array_equal(back.toarray(), dense)
