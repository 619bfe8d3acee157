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
    pp = poisson_problem(3, N_EL, degree=DEGREE, device="cpu", operator="kron")
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

    pp = poisson_problem(3, 8, degree=2, device="cpu", operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    pcg = MGPreconditionedCG(pp, 2, cfg, operator="kron", precision="dw")
    x, rn, it = pcg.solve_compiled(tol=TOL, maxiter=30)
    x2, rn2, it2 = pcg.solve_compiled(
        tol=TOL, maxiter=30, b_pair=split_f64(pp.b.interior))
    assert it2 == it and torch.equal(x2.interior, x.interior)
    # dwrr and the defect-correction solver are ported (their parity tests
    # are in test_torch_mixed.py), and so are bf16 cycles (test_torch_bf16.py)
    assert MGPreconditionedCG(pp, 2, cfg, operator="kron",
                              precision="dwrr").replace_every == 3
    assert MixedPrecisionMG(pp, 2, cfg,
                            operator="kron").residual_mode == "twofloat"
    low = MGPreconditionedCG(pp, 2, cfg, operator="kron", precision="dw",
                             low_dtype=torch.bfloat16)
    assert low.levels_pre[0].A.space.dtype == torch.bfloat16
    res = low.solve(tol=TOL, maxiter=30)
    assert res.converged and res.iterations <= 2 * it
    res = MixedPrecisionMG(pp, 2, cfg, operator="kron",
                           low_dtype=torch.bfloat16).solve(tol=TOL,
                                                           maxiter=30)
    assert res.converged and res.residuals[-1] <= TOL
    with pytest.raises(ValueError):
        MGPreconditionedCG(pp, 2, cfg, operator="kron", precision="dwx")
    with pytest.raises(ValueError):
        MGPreconditionedCG(pp, 2, cfg, operator="kron", mixed=False,
                           precision="dw")
    # the double-word apply needs the Kronecker-sum operator, as in the
    # JAX package (poms_tpu/mg/mixed.py:401-404)
    banded = poisson_problem(3, 8, degree=2, device="cpu")
    with pytest.raises(ValueError):
        MGPreconditionedCG(banded, 2, cfg, precision="dw")
    with pytest.raises(ValueError):
        RefPCG(ref_problem(3, 8, degree=2), 2, RefCycle(), precision="dw")


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
    port = MGPreconditionedCG(poisson_problem(3, 8, degree=3, device="cpu",
                                              operator="kron"), 2, CycleConfig(
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


def test_banded_f64_mixed_pcg_matches_jax():
    """The banded path end to end: f64-mixed PCG (f64 recurrences and K2
    f64 SpMV, f32 banded V-cycle) at 16³ p3, 2 levels, against the JAX
    reference run eagerly, with the reference's λs: equal iterations,
    histories within 1e-3 through iteration 3 and 5e-2 after.

    The f32 smoothing is bitwise equal to the reference's eager run; the
    only rounding difference is the f32 coarse triangular solves (4e-7
    relative), which PCG amplifies to 2.7e-3 at iteration 4 (measured).
    The reference's own jitted and eager runs differ by 9e-4 there and by
    up to 9e-2 later, so the bound stops at iteration 3."""
    cyc = dict(nu1=1, nu2=1)
    with jax.disable_jit():
        rp = ref_problem(3, N_EL, degree=DEGREE)
        ref = RefPCG(rp, LEVELS, RefCycle(**cyc, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0)), mixed=True, precision="f64")
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=30)
    pp = poisson_problem(3, N_EL, degree=DEGREE, device="cpu")
    port = MGPreconditionedCG(pp, LEVELS, CycleConfig(
        **cyc, smoother=SmootherConfig("chebyshev", cheb_fraction=16.0)),
        mixed=True, precision="f64")
    assert port.levels_pre[0].A.band_t.dtype == torch.float32
    port.lams = convert.lams(lams)
    pres = port.solve(tol=TOL, maxiter=30)
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
