"""The port's StencilVector and ghost fill against ``poms_tpu.core.vector``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poms_tpu.core.space import StencilVectorSpace as RefSpace
from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.core.vector import update_ghosts_serial as ref_ghosts
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import (StencilVector, ghost_pad,
                                        update_ghosts_serial)

torch.set_num_threads(1)

CASES = [((7,), 2, (False,)), ((6, 9), 3, (True, False)),
         ((5, 6, 7), 2, (False, False, False)), ((5, 6, 7), 1, (True,) * 3),
         ((4, 5, 6), 3, (False, True, False))]


def _spaces(npts, p, periodic):
    return (RefSpace(npts=npts, pads=p, periodic=periodic),
            StencilVectorSpace(npts=npts, pads=p, periodic=periodic,
                               device="cpu"))


@pytest.mark.parametrize("npts,p,periodic", CASES)
def test_ghost_fill_bitwise(npts, p, periodic):
    rs, ps = _spaces(npts, p, periodic)
    data = np.random.default_rng(0).standard_normal(ps.padded_shape)
    want = np.asarray(ref_ghosts(jnp.asarray(data), rs))
    assert want.dtype == np.float64
    np.testing.assert_array_equal(
        update_ghosts_serial(torch.from_numpy(data), ps).numpy(), want)
    # ghost_pad of the interior gives the same padded field
    interior = torch.from_numpy(data)[ps.interior]
    np.testing.assert_array_equal(
        ghost_pad(interior, ps.pads, ps.periodic).numpy(), want)


@pytest.mark.parametrize("npts,p,periodic", CASES)
def test_vector_algebra_matches_jax(npts, p, periodic):
    rs, ps = _spaces(npts, p, periodic)
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(npts), rng.standard_normal(npts)
    rx, ry = RefVec.from_interior(rs, x), RefVec.from_interior(rs, y)
    px = StencilVector.from_interior(ps, torch.from_numpy(x))
    py = StencilVector.from_interior(ps, torch.from_numpy(y))
    np.testing.assert_array_equal(px.data.numpy(), np.asarray(rx.data))
    np.testing.assert_array_equal(px.axpy(0.3, py).data.numpy(),
                                  np.asarray(rx.axpy(0.3, ry).data))
    assert abs(float(px.dot(py)) - float(rx.dot(ry))) <= 1e-13 * x.size
    assert abs(float(px.norm()) - float(rx.norm())) <= 1e-13 * x.size
    z = StencilVector.zeros(ps)
    assert z.data.shape == ps.padded_shape and not z.data.any()
    with pytest.raises(ValueError):
        StencilVector.from_interior(ps, torch.zeros(npts[:-1] + (1,)))


@pytest.mark.parametrize("npts,p,periodic", CASES)
def test_scalar_multiple_and_negation_match_jax(npts, p, periodic):
    rs, ps = _spaces(npts, p, periodic)
    x = np.random.default_rng(2).standard_normal(npts)
    rx = RefVec.from_interior(rs, x)
    px = StencilVector.from_interior(ps, torch.from_numpy(x))
    for got, want in ((px * 0.3, rx * 0.3), (0.3 * px, 0.3 * rx),
                      (-px, -rx)):
        assert isinstance(got, StencilVector) and got.space is ps
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))


def test_space_coarsen_is_refused_as_in_jax():
    rs, ps = _spaces((6, 9), 3, (True, False))
    with pytest.raises(NotImplementedError):
        rs.coarsen()
    with pytest.raises(NotImplementedError):
        ps.coarsen()
