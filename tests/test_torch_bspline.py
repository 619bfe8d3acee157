"""The port's copy of the host B-spline code against ``poms_tpu.models.bspline``.

The copy is verbatim numpy, so every array must be bitwise equal.
"""
import numpy as np
import pytest
import torch

from poms_tpu.models import bspline as ref
from poms_tpu_torch.models import bspline as port

torch.set_num_threads(1)

CASES = [(8, 1), (16, 2), (16, 3), (32, 3)]


def _f64(a):
    a = np.asarray(a)
    assert a.dtype == np.float64, a.dtype
    return a


@pytest.mark.parametrize("n_el,p", CASES)
def test_assembly_bitwise(n_el, p):
    r, s = ref.assemble_spline_1d(n_el, p), port.assemble_spline_1d(n_el, p)
    assert (r.nb, r.n) == (s.nb, s.n)
    for name in ("knots", "K", "M", "K_full", "M_full"):
        np.testing.assert_array_equal(getattr(s, name),
                                      _f64(getattr(r, name)), err_msg=name)
    np.testing.assert_array_equal(port.interior_band(s.K_full, p),
                                  _f64(ref.interior_band(r.K_full, p)))


@pytest.mark.parametrize("n_el,p", CASES)
def test_prolongation_bitwise(n_el, p):
    np.testing.assert_array_equal(
        port.prolongation_interior_1d(n_el // 2, p),
        _f64(ref.prolongation_interior_1d(n_el // 2, p)))


@pytest.mark.parametrize("n_el,p", CASES)
def test_sin_moment_and_basis_bitwise(n_el, p):
    r, s = ref.assemble_spline_1d(n_el, p), port.assemble_spline_1d(n_el, p)
    np.testing.assert_array_equal(port.sin_moment_1d(s, m=1, interior=True),
                                  _f64(ref.sin_moment_1d(r, m=1,
                                                         interior=True)))
    for x in np.random.default_rng(n_el + p).random(16):
        k = ref.find_span(r.knots, p, x)
        assert port.find_span(s.knots, p, x) == k
        np.testing.assert_array_equal(port.basis_funs(s.knots, p, k, x),
                                      _f64(ref.basis_funs(r.knots, p, k, x)))
