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
