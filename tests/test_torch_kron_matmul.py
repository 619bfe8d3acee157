"""The dense-matmul Kronecker-sum apply (the JAX package's
``POMS_TPU_KRON=matmul``, the port's K1 yardstick) against the JAX
package's and against the port's plain apply, 16³ p3.

Tolerances, of max|y|: f64 1e-12 (the same products summed in another
order), f32 1e-5 (as K1's f32 checks: another order of the sums).  The JAX
apply runs at its default ``Precision.HIGHEST``; the port's keeps TF32 off
unless called with ``tf32=True``.
"""
import numpy as np
import pytest
import torch

from poms_tpu_torch.ops.kron import kron_apply

torch.set_num_threads(1)

NPTS, P = (16, 16, 16), 3
TOL = {32: 1e-5, 64: 1e-12}


def _pair(dtype, periodic=False):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_torch_kron import _pair as pair

    return pair(NPTS, P, periodic, dtype, seed=5)


def _vector(op, x_int):
    from poms_tpu_torch.core.vector import StencilVector

    return StencilVector.from_interior(op.space, x_int)


def _rel(out, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("bits", [32, 64])
def test_matmul_apply_matches_jax_and_plain(bits):
    ref, op, xj, xt = _pair(bits)
    got = op._apply_interior_matmul(xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == NPTS
    assert _rel(got.numpy(), ref._apply_interior_matmul(xj)) <= TOL[bits]
    assert _rel(got.numpy(), op._apply_interior(xt).numpy()) <= TOL[bits]


@pytest.mark.parametrize("bits", [32, 64])
def test_band_to_dense_matches_jax(bits):
    ref, op, _, _ = _pair(bits)
    for a in range(3):
        B_ref, B = ref.terms[0][a], op.terms[0][a]
        np.testing.assert_array_equal(op._band_to_dense(B, P).numpy(),
                                      np.asarray(ref._band_to_dense(B_ref,
                                                                    P)))


def test_apply_stays_on_k1_whatever_the_environment(monkeypatch):
    """The JAX package's ``POMS_TPU_KRON=matmul`` switch is not ported: the
    operator's apply is K1's apply (its plain version here) with the
    variable set; the matmul apply is reached only by name."""
    _, op, _, xt = _pair(64)
    monkeypatch.setenv("POMS_TPU_KRON", "matmul")
    assert torch.equal(op._apply_interior(xt), op._mode("apply", xt))
    assert torch.equal(op.dot(_vector(op, xt)).interior,
                       op._mode("apply", xt))


def test_matmul_apply_refuses_periodic_and_restores_tf32():
    """Non-periodic only, as in the JAX package; ``tf32=True`` changes
    PyTorch's TF32 flag for the products and restores it after."""
    _, per, _, xp = _pair(64, periodic=True)
    with pytest.raises(ValueError):
        per._apply_interior_matmul(xp)
    _, op, _, xt = _pair(32)
    flag = torch.backends.cuda.matmul.allow_tf32
    # on the CPU TF32 never applies: the same products either way
    assert torch.equal(op._apply_interior_matmul(xt, tf32=True),
                       op._apply_interior_matmul(xt))
    assert torch.backends.cuda.matmul.allow_tf32 == flag
