"""The slice end to end: the port's MG-preconditioned CG against the JAX
package's on 3D Poisson, n_el = 16, p = 3, 2 levels, with the headline
configuration (Chebyshev(4) over [λmax/16, λmax], ν1 = ν2 = 1, tol 1e-10).

The reference runs eagerly (``jax.disable_jit``): XLA:CPU takes minutes to
compile the double-word graphs.  The port's ``lams`` are set to the
reference's estimates, since the reference draws its power-iteration start
vector from ``jax.random``.
"""
import jax
import numpy as np
import pytest
import torch

from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models.poisson import l2_error_manufactured as ref_l2
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu_torch import convert
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)

torch.set_num_threads(1)

N_EL, DEGREE, LEVELS, TOL = 16, 3, 2, 1e-10


def _solve_both(precision):
    with jax.disable_jit():
        rp = ref_problem(3, N_EL, degree=DEGREE, operator="kron")
        ref = RefPCG(rp, LEVELS, RefCycle(nu1=1, nu2=1, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0)), mixed=True, operator="kron",
            precision=precision)
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=30)
    pp = poisson_problem(3, N_EL, degree=DEGREE)
    port = MGPreconditionedCG(pp, LEVELS, CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)),
        mixed=True, operator="kron", precision=precision)
    port.lams = convert.lams(lams)
    return rp, rres, pp, port, port.solve(tol=TOL, maxiter=30)


@pytest.fixture(scope="module", params=["dw", "f64"])
def solved(request):
    return (request.param,) + _solve_both(request.param)


def test_same_iterations_and_history(solved):
    precision, _, rres, _, _, pres = solved
    assert pres.iterations == rres.iterations, (pres.iterations,
                                                rres.iterations)
    if precision == "dw":
        assert pres.iterations == 13   # measured for this configuration
    for i, (a, b) in enumerate(zip(pres.residuals, rres.residuals)):
        tol = 1e-3 if i <= 4 else 5e-2
        assert abs(a - b) <= tol * b, (i, a, b)


def test_converged_with_true_residual(solved):
    _, _, rres, pp, _, pres = solved
    assert rres.converged and pres.converged
    assert rres.residuals[-1] <= TOL and pres.residuals[-1] <= TOL
    r = pp.b.interior - pp.A.dot(pres.x).interior
    assert r.dtype == torch.float64
    assert float(torch.linalg.vector_norm(r)) <= 5e-10


def test_solution_matches(solved):
    _, rp, rres, pp, _, pres = solved
    want = np.asarray(rres.x.interior)
    assert want.dtype == np.float64
    got = pres.x.interior.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert abs(l2_error_manufactured(pp, pres.x)
               - ref_l2(rp, rres.x)) <= 1e-9


def test_solve_compiled_matches_solve(solved):
    """The history-free loop runs the same iterations as ``solve``."""
    _, _, _, _, port, pres = solved
    x, rn, it = port.solve_compiled(tol=TOL, maxiter=30)
    assert it == pres.iterations
    assert float(rn) == pres.residuals[-1]
    assert torch.equal(x.interior, pres.x.interior)
    x_int, _, _ = port.solve_compiled(tol=TOL, maxiter=30, return_x=False)
    assert torch.equal(x_int, pres.x.interior)


def test_dw_b_pair_and_unported_options():
    from poms_tpu_torch.ops.twofloat import split_f64

    pp = poisson_problem(3, 8, degree=2)
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    pcg = MGPreconditionedCG(pp, 2, cfg, precision="dw")
    x, rn, it = pcg.solve_compiled(tol=TOL, maxiter=30)
    x2, rn2, it2 = pcg.solve_compiled(
        tol=TOL, maxiter=30, b_pair=split_f64(pp.b.interior))
    assert it2 == it and torch.equal(x2.interior, x.interior)
    with pytest.raises(NotImplementedError):
        MGPreconditionedCG(pp, 2, cfg, precision="dwrr")
    with pytest.raises(NotImplementedError):
        MGPreconditionedCG(pp, 2, cfg, low_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        MixedPrecisionMG(pp, 2)
    with pytest.raises(NotImplementedError):
        poisson_problem(3, 8, operator="banded")
    with pytest.raises(ValueError):
        MGPreconditionedCG(pp, 2, cfg, mixed=False, precision="dw")


def test_f64_unmixed_matches_jax():
    """mixed=False: the f64 cycle as preconditioner (3D n_el=8, p=3)."""
    cheb = dict(nu1=1, nu2=1)
    with jax.disable_jit():
        rp = ref_problem(3, 8, degree=3, operator="kron")
        ref = RefPCG(rp, 2, RefCycle(**cheb, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0)), mixed=False,
            operator="kron", precision="f64")
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=30)
    port = MGPreconditionedCG(poisson_problem(3, 8, degree=3), 2, CycleConfig(
        **cheb, smoother=SmootherConfig("chebyshev", cheb_fraction=16.0)),
        mixed=False, operator="kron", precision="f64")
    assert port.levels_pre is port.levels
    port.lams = convert.lams(lams)
    pres = port.solve(tol=TOL, maxiter=30)
    assert pres.converged and pres.iterations == rres.iterations
    for a, b in zip(pres.residuals, rres.residuals):
        assert abs(a - b) <= 1e-6 * b, (a, b)
    want = np.asarray(rres.x.interior)
    assert want.dtype == np.float64
    assert (np.abs(pres.x.interior.numpy() - want).max()
            <= 1e-9 * np.abs(want).max())
