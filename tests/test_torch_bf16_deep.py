"""bf16 cycles on a deep 3D hierarchy, the JAX package beside the port.

Outside the default tier (marked slow; the four 32³ cases take about 12
minutes in one process, the 64³ ones far longer):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bf16_deep.py -m slow \
        -s -n 0 -k 32-3

The two-level cases of ``tests/test_torch_bf16.py`` cost a bf16 cycle 2 to 4
corrections more than an f32 one.  In 3D with cubic splines and three or
more levels a bf16 cycle stalls after a few corrections and then contracts
by about 0.85 a correction: 70 to 90 corrections where f32 takes 10 to 23.
This file shows that this is the method's behaviour, in both packages, and
not a fault of the port that only a deep hierarchy would bring out: with the
reference's λ estimates the port takes no more corrections than the
reference + 2, in f32 and in bf16, and its answer holds in f64.
"""
import contextlib

import jax
import jax.numpy as jnp
import pytest
import torch

from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.mixed import MixedPrecisionMG as RefMG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu_torch import convert
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem

TOL = 1e-10
MAXITER = 200
LOWS = {"f32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.slow
@pytest.mark.parametrize("low", ["f32", "bf16"])
@pytest.mark.parametrize("n_el,levels", [(32, 3), (64, 4)])
@pytest.mark.parametrize("operator,residual", [("banded", "f64"),
                                               ("kron", "twofloat")])
def test_deep_bf16_counts_beside_jax(operator, residual, n_el, levels, low):
    """Chebyshev(4) over [λmax/32, λmax], ν1 = ν2 = 1, to 1e-10: the
    128³ configuration of ``chip_smoke.py`` at a depth the CPU can hold."""
    ref_low, port_low = LOWS[low]
    kw = dict(nu1=1, nu2=1)
    sm = dict(cheb_fraction=32.0, cheb_degree=4)
    # the double-word graphs take XLA:CPU minutes to compile: run them eagerly
    ctx = (jax.disable_jit() if residual == "twofloat"
           else contextlib.nullcontext())
    with ctx:
        rp = ref_problem(3, n_el, degree=3, operator=operator)
        ref = RefMG(rp, levels, RefCycle(smoother=RefSmoother("chebyshev",
                                                              **sm), **kw),
                    low_dtype=ref_low, operator=operator, residual=residual)
        lams = ref_lams(ref.levels64, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=MAXITER)
    pp = poisson_problem(3, n_el, degree=3, device="cpu", operator=operator)
    port = MixedPrecisionMG(pp, levels, CycleConfig(
        smoother=SmootherConfig("chebyshev", **sm), **kw),
        low_dtype=port_low, operator=operator, residual=residual)
    port.lams = convert.lams(lams)
    pres = port.solve(tol=TOL, maxiter=MAXITER)
    print(f"{operator} {residual} {n_el}^3 {levels} levels {low}: reference "
          f"{rres.iterations}, port {pres.iterations} corrections")
    print("reference", ["%.3e" % r for r in rres.residuals[:10]])
    print("port     ", ["%.3e" % r for r in pres.residuals[:10]])
    assert rres.converged and pres.converged
    assert pres.iterations <= rres.iterations + 2, (pres.iterations,
                                                    rres.iterations)
    r = pp.b.interior - pp.A.dot(pres.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
