"""The headline dw-PCG at 64³ on the CPU: the JAX package (run eagerly)
beside the port, with the reference's λ estimates.  Outside the default
tier (marked slow; about 10 minutes on two cores):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pcg_64.py -m slow -s

It answers whether the two packages take the same number of iterations at a
production-like size and depth (4 levels), where the 16³ parity test has
only two.  Both run their plain double-word trees on the CPU, so the
summation orders agree.
"""
import jax
import pytest
import torch

from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu_torch import convert
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem


@pytest.mark.slow
def test_dw_pcg_64_same_iterations_as_jax():
    n_el, levels = 64, 4
    with jax.disable_jit():
        rp = ref_problem(3, n_el, degree=3, operator="kron")
        ref = RefPCG(rp, levels, RefCycle(nu1=1, nu2=1, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0)), mixed=True, operator="kron",
            precision="dw")
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=1e-10, maxiter=30)
    pp = poisson_problem(3, n_el, degree=3, device="cpu", operator="kron")
    port = MGPreconditionedCG(pp, levels, CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)),
        mixed=True, operator="kron", precision="dw")
    own = port.lams
    port.lams = convert.lams(lams)
    pres = port.solve(tol=1e-10, maxiter=30)
    print("reference lams", lams, "port's own", own)
    print("reference", rres.iterations, ["%.4e" % r for r in rres.residuals])
    print("port     ", pres.iterations, ["%.4e" % r for r in pres.residuals])
    first = next((i for i, (a, b) in enumerate(zip(pres.residuals,
                                                   rres.residuals))
                  if abs(a - b) > 1e-3 * b), None)
    print("first history entry differing by more than 1e-3:", first)
    assert rres.converged and pres.converged
    assert pres.iterations == rres.iterations
    r = pp.b.interior - pp.A.dot(pres.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
