"""K1 (the Kronecker-sum apply) and the port's KroneckerSumOperator against
the JAX package.

On the CPU the wrapper runs its plain version; it is held against
``KroneckerSumOperator._apply_interior`` and against the Pallas kernel in
interpret mode on the four shapes of tests/test_pallas_kron.py.  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poms_tpu.core.kron import KroneckerSumOperator as RefKron
from poms_tpu.core.space import StencilVectorSpace as RefSpace
from poms_tpu.ops.pallas.kron import kron_apply_pallas
from poms_tpu_torch import convert
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.ops.kron import kron_apply, kron_apply_plain

torch.set_num_threads(1)

CASES = [
    ((8, 12, 130), 2, False),
    ((10, 130, 140), 3, False),    # ragged: grid padding on every dim
    ((8, 8, 128), 2, True),        # periodic wrap
    ((6, 64, 96), 1, False),       # small t0 / minimum lane width
]


def _bands(npts, p, seed, clip):
    """Poisson-shaped terms (K on axis a, M elsewhere) from numpy; with
    ``clip`` the entries that reach past a Dirichlet edge are zero."""
    rng = np.random.default_rng(seed)
    Ks = [rng.standard_normal((n, 2 * p + 1)) / 4 for n in npts]
    Ms = [rng.standard_normal((n, 2 * p + 1)) / 4 for n in npts]
    x = rng.standard_normal(npts)
    if clip:
        for B in Ks + Ms:
            cols = np.arange(len(B))[:, None] + np.arange(2 * p + 1) - p
            B[(cols < 0) | (cols >= len(B))] = 0.0
    return Ks, Ms, x


def _pair(npts, p, periodic, dtype, seed=0, clip=False):
    """The same operator and input in both packages."""
    d = len(npts)
    Ks, Ms, x = _bands(npts, p, seed, clip)
    jdt, tdt = {64: (jnp.float64, torch.float64),
                32: (jnp.float32, torch.float32)}[dtype]
    ref_sp = RefSpace(npts=npts, pads=(p,) * d, periodic=(periodic,) * d,
                      dtype=jdt)
    Kj = [jnp.asarray(K, jdt) for K in Ks]
    Mj = [jnp.asarray(M, jdt) for M in Ms]
    ref = RefKron(ref_sp, [[Kj[b] if b == a else Mj[b] for b in range(d)]
                           for a in range(d)])
    sp = StencilVectorSpace(npts=npts, pads=(p,) * d,
                            periodic=(periodic,) * d, dtype=tdt)
    Kt = [torch.as_tensor(K, dtype=tdt) for K in Ks]
    Mt = [torch.as_tensor(M, dtype=tdt) for M in Ms]
    op = KroneckerSumOperator(sp, [[Kt[b] if b == a else Mt[b]
                                    for b in range(d)] for a in range(d)])
    return ref, op, jnp.asarray(x, jdt), torch.as_tensor(x, dtype=tdt)


def _rel(out, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("npts,p,periodic", CASES)
def test_plain_k1_matches_jax_and_pallas_f32(npts, p, periodic):
    """f32, ≤ 1e-5 of max|y| (the terms are summed in another order than
    the Pallas kernel's)."""
    ref, op, xj, xt = _pair(npts, p, periodic, 32)
    before = kron_apply.launches
    out = op._apply_interior(xt)
    assert kron_apply.launches == before      # CPU tensors: plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == npts
    assert _rel(out, ref._apply_interior(xj)) <= 1e-5
    pallas = kron_apply_pallas(ref.terms, xj, npts, (p,) * 3,
                               (periodic,) * 3, interpret=True)
    assert _rel(out, pallas) <= 1e-5


@pytest.mark.parametrize("npts,p,periodic", CASES)
def test_plain_k1_matches_jax_f64(npts, p, periodic):
    """f64 against the JAX apply, ≤ 1e-13 of max|y|."""
    ref, op, xj, xt = _pair(npts, p, periodic, 64, seed=1)
    want = np.asarray(ref._apply_interior(xj))
    assert want.dtype == np.float64
    assert _rel(op._apply_interior(xt), want) <= 1e-13


@pytest.mark.parametrize("npts,p,periodic", [((40,), 3, False),
                                             ((33,), 2, True),
                                             ((17, 23), 3, False),
                                             ((12, 16), 2, True)])
def test_plain_k1_1d_2d(npts, p, periodic):
    ref, op, xj, xt = _pair(npts, p, periodic, 64, seed=2)
    want = np.asarray(ref._apply_interior(xj))
    assert want.dtype == np.float64
    assert _rel(op._apply_interior(xt), want) <= 1e-13


@pytest.mark.parametrize("periodic", [False, True])
def test_diagonal_transpose_toarray(periodic):
    npts, p = (7, 9, 11), 2
    ref, op, _, _ = _pair(npts, p, periodic, 64, seed=3, clip=not periodic)
    diag = np.asarray(ref.diagonal())
    assert diag.dtype == np.float64
    np.testing.assert_allclose(op.diagonal().numpy(), diag, rtol=1e-15,
                               atol=0)
    for rt, pt in zip(ref.transpose().terms, op.transpose().terms):
        for Br, Bp in zip(rt, pt):
            np.testing.assert_array_equal(Bp.numpy(), np.asarray(Br))
    if not periodic:   # the JAX toarray goes through the banded format
        dense = np.asarray(ref.toarray())
        assert dense.dtype == np.float64
        np.testing.assert_allclose(op.toarray(), dense, rtol=0, atol=1e-14)


def test_toarray_matches_apply_periodic():
    """toarray's periodic branch against the operator's own apply."""
    _, op, _, xt = _pair((5, 6, 7), 2, True, 64, seed=4)
    y = op.toarray() @ xt.numpy().ravel()
    np.testing.assert_allclose(y, op._apply_interior(xt).numpy().ravel(),
                               rtol=0, atol=1e-13)


def test_convert_keeps_sharing():
    ref, op, xj, xt = _pair((6, 7, 8), 2, False, 64, seed=5)
    conv = convert.kron_operator(ref)
    assert conv._band_labels() == op._band_labels() == [[0, 1, 1],
                                                         [0, 1, 0],
                                                         [0, 0, 1]]
    np.testing.assert_array_equal(conv._apply_interior(xt).numpy(),
                                  op._apply_interior(xt).numpy())


def test_shared_partials_equal_independent_terms():
    """The shared-partial chain equals the term-by-term sum the kernel
    computes (same values, other summation order)."""
    _, op, _, xt = _pair((9, 10, 11), 3, False, 64, seed=6)
    separate = [[B.clone() for B in term] for term in op.terms]
    y_shared = kron_apply_plain(op.terms, xt, op.space.npts, op.space.pads,
                                op.space.periodic)
    y_sep = kron_apply_plain(separate, xt, op.space.npts, op.space.pads,
                             op.space.periodic)
    assert _rel(y_shared, y_sep.numpy()) <= 1e-14


def test_kron_apply_rejects_other_devices():
    _, op, _, xt = _pair((4, 5, 6), 1, False, 32, seed=7)
    with pytest.raises(NotImplementedError):
        kron_apply(op.terms, xt.to("meta"), op.space.npts, op.space.pads,
                   op.space.periodic)
