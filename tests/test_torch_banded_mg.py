"""The banded multigrid path against ``poms_tpu.mg`` on the CPU.

- Banded hierarchies, by host SpGEMM and by the tensor composition: every
  level's band within 1e-13 of the reference's (relative to its max).
- ``MultigridSolver`` in f64: equal iteration counts and residual histories
  within rtol 1e-9 plus an absolute floor of 1e-14·‖b‖.  The floor is the
  f64 rounding of a residual b − Ax: the two packages sum the same terms in
  the same order but XLA contracts some multiply-adds, and the measured
  difference stays below 1e-15·‖b‖ at every cycle, which is a relative
  1e-5 once ‖r‖ is near 1e-10·‖b‖.
- The repaired faults of the port: RB-GS on Kronecker-sum operators, ω = 1
  for the Gauss–Seidel smoothers, and the ``operator`` defaults.
"""
import inspect

import numpy as np
import pytest
import torch

from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.mg import cycles as ref_cycles
from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.hierarchy import build_hierarchy as ref_build
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.mixed import _cast_levels as ref_cast
from poms_tpu.mg.solver import MultigridSolver as RefSolver
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu_torch import convert
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg import cycles
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.hierarchy import build_hierarchy
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, _cast_levels
from poms_tpu_torch.mg.smoother import SmootherConfig, resolve_omega
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import poisson_problem

torch.set_num_threads(1)


def _f64(a):
    a = np.asarray(a)
    assert a.dtype == np.float64, a.dtype
    return a


@pytest.mark.parametrize("dim,n_el,p,levels", [(2, 16, 3, 3), (3, 8, 2, 2),
                                               (1, 32, 3, 3)])
@pytest.mark.parametrize("method", ["spgemm", "tensor"])
def test_banded_hierarchy_matches_jax(dim, n_el, p, levels, method):
    rl = ref_build(ref_problem(dim, n_el, degree=p), levels, method=method)
    pl = build_hierarchy(poisson_problem(dim, n_el, degree=p, device="cpu"), levels,
                         method=method)
    assert len(pl) == len(rl)
    for plev, rlev in zip(pl, rl):
        assert isinstance(plev.A, StencilMatrix)
        assert plev.A.space.npts == rlev.A.space.npts
        want = _f64(rlev.A.band_t)
        got = plev.A.band_t.numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
        for kind in ("restrict", "prolong"):
            for p_tb, r_tb in zip(getattr(plev, kind) or (),
                                  getattr(rlev, kind) or ()):
                np.testing.assert_array_equal(p_tb.w.numpy(), _f64(r_tb.w))
    L = _f64(rl[-1].chol.L)
    assert np.abs(pl[-1].chol.L.numpy() - L).max() <= 1e-12 * np.abs(L).max()


@pytest.mark.parametrize("kind,bits", [("rbgs", 64), ("jacobi", 64),
                                       ("rbgs", 32)])
def test_banded_cycle_on_carried_levels(kind, bits):
    """One V-cycle on the reference's banded levels carried over with
    ``convert.levels`` (cast to f32 by each package's ``_cast_levels``):
    ≤ 1e-12 in f64; ≤ 1e-5 in f32, where the coarse triangular solves
    round differently."""
    import jax.numpy as jnp

    rl = ref_build(ref_problem(3, 8, degree=3), 2)
    pl = convert.levels(rl)
    if bits == 32:
        rl, pl = ref_cast(rl, jnp.float32), _cast_levels(pl, torch.float32)
    assert isinstance(pl[0].A, StencilMatrix)
    assert pl[0].A.band_t.dtype == (torch.float64 if bits == 64
                                    else torch.float32)
    sm = dict(kind=kind, omega=1.0 if kind == "rbgs" else 0.7)
    b = np.random.default_rng(1).standard_normal(pl[0].A.space.npts)
    rsp, psp = rl[0].A.space, pl[0].A.space
    want = np.asarray(ref_cycles.cycle(
        rl, 0, RefVec.zeros(rsp), RefVec.from_interior(rsp, b.astype(
            rsp.dtype)), RefCycle(smoother=RefSmoother(**sm))).interior)
    got = cycles.cycle(pl, 0, StencilVector.zeros(psp),
                       StencilVector.from_interior(psp, torch.from_numpy(b)),
                       CycleConfig(smoother=SmootherConfig(**sm)))
    rel = np.abs(got.interior.numpy() - want).max() / np.abs(want).max()
    assert rel <= (1e-12 if bits == 64 else 1e-5), rel


def test_spgemm_and_tensor_agree():
    """The two coarse-operator methods build the same operator."""
    prob = poisson_problem(2, 16, degree=3, device="cpu")
    a = build_hierarchy(prob, 3, method="spgemm")
    b = build_hierarchy(prob, 3, method="tensor")
    for la, lb in zip(a, b):
        want = lb.A.band_t.numpy()
        assert np.abs(la.A.band_t.numpy() - want).max() <= \
            1e-13 * np.abs(want).max()
    with pytest.raises(ValueError):
        build_hierarchy(prob, 3, method="dense")


def _histories_match(got, want, b_norm):
    assert got.iterations == want.iterations, (got.iterations,
                                               want.iterations)
    for i, (a, b) in enumerate(zip(got.residuals, want.residuals)):
        assert abs(a - b) <= 1e-9 * b + 1e-14 * b_norm, (i, a, b)


# config 1: 1D cubic, 2-grid, weighted Jacobi (examples/poisson_1d.py);
# config 2: 2D 32², 3 levels, Jacobi ω = 0.8; config 3: 3D n_el = 8 p3,
# 2 levels, RB-GS ω = 1 (p3 RB-GS cycles stall near ρ ≈ 0.95, so both
# packages stop at maxiter); then a W-cycle, FMG and lexicographic GS
SOLVES = {
    "config1": (1, 64, 3, 2, dict(kind="jacobi", omega=2 / 3), {}, {}),
    "config2": (2, 32, 3, 3, dict(kind="jacobi", omega=0.8), {}, {}),
    "config3": (3, 8, 3, 2, dict(kind="rbgs", omega=1.0), {},
                dict(maxiter=12)),
    "wcycle": (2, 16, 2, 3, dict(kind="jacobi", omega=0.8), dict(gamma=2),
               {}),
    "fmg": (2, 16, 3, 3, dict(kind="jacobi", omega=0.8), {},
            dict(use_fmg=True)),
    "gs_lex": (1, 16, 2, 2, dict(kind="gs_lex", omega=1.0), {}, {}),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_multigrid_solver_history_matches_jax(name):
    dim, n_el, p, levels, sm, cyc, solve_kw = SOLVES[name]
    solve_kw = dict(dict(tol=1e-10, maxiter=60), **solve_kw)
    ref = RefSolver(ref_problem(dim, n_el, degree=p), levels,
                    RefCycle(**cyc, smoother=RefSmoother(**sm)))
    want = ref.solve(**solve_kw)
    prob = poisson_problem(dim, n_el, degree=p, device="cpu")
    port = MultigridSolver(prob, levels,
                           CycleConfig(**cyc, smoother=SmootherConfig(**sm)))
    got = port.solve(**solve_kw)
    _histories_match(got, want, float(prob.b.norm()))
    x_want = _f64(want.x.interior)
    assert np.abs(got.x.interior.numpy() - x_want).max() <= \
        1e-9 * np.abs(x_want).max()
    if name != "config3":
        assert got.converged and want.converged


def test_solve_compiled_matches_solve():
    prob = poisson_problem(2, 16, degree=3, device="cpu")
    mg = MultigridSolver(prob, 3, CycleConfig(smoother=SmootherConfig(
        "jacobi", 0.8)))
    res = mg.solve(tol=1e-10, maxiter=60)
    x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=60)
    assert it == res.iterations and float(rn) == res.residuals[-1]
    assert torch.equal(x.interior, res.x.interior)
    rel = mg.solve(tol=1e-6, maxiter=60, rtol=True)
    assert rel.residuals[-1] <= 1e-6 * float(prob.b.norm())
    # the logger is ported: one record per cycle, the history unchanged
    import io
    import json

    from poms_tpu_torch.utils.logging import ConvergenceLogger

    buf = io.StringIO()
    logged = mg.solve(tol=1e-10, maxiter=60, logger=ConvergenceLogger(buf))
    assert logged.residuals == res.residuals
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["residual"] for r in recs] == res.residuals[1:]


# -- the port's repaired faults ----------------------------------------------

@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_kron_solver_matches_banded(smoother):
    """tests/test_kron.py:50-60 of the JAX package, in the port: the
    Kronecker-sum and banded solvers give the same history (RB-GS on a
    Kronecker-sum operator takes the generic masked path)."""
    prob = poisson_problem(2, 32, degree=3, device="cpu")
    cfg = CycleConfig(smoother=SmootherConfig(smoother, 0.8))
    res_b = MultigridSolver(prob, 3, cfg, operator="banded").solve(
        tol=1e-10, maxiter=60)
    res_k = MultigridSolver(prob, 3, cfg, operator="kron").solve(
        tol=1e-10, maxiter=60)
    assert res_k.converged and res_k.iterations == res_b.iterations
    np.testing.assert_allclose(res_k.residuals, res_b.residuals, rtol=1e-6,
                               atol=1e-13)


@pytest.mark.parametrize("operator", ["banded", "kron"])
@pytest.mark.parametrize("kind", ["rbgs", "gs_lex"])
def test_resolve_omega_gauss_seidel_is_one(operator, kind):
    A = poisson_problem(3, 4, degree=3, device="cpu", operator=operator).A
    assert resolve_omega(SmootherConfig(kind), A).omega == 1.0
    assert resolve_omega(SmootherConfig(kind, omega=0.7), A).omega == 0.7


@pytest.mark.parametrize("ours,ref", [
    (poisson_problem, ref_problem), (build_hierarchy, ref_build),
    (MultigridSolver.__init__, RefSolver.__init__),
    (MGPreconditionedCG.__init__, RefPCG.__init__)])
def test_operator_defaults_match_jax(ours, ref):
    mine = inspect.signature(ours).parameters["operator"].default
    theirs = inspect.signature(ref).parameters["operator"].default
    assert mine == theirs == "banded"


def test_estimate_takes_any_operator():
    """The λ estimate works on an f32 copy of a banded or kron operator."""
    from poms_tpu_torch.mg.smoother import estimate_dinv_a_lambda_max

    lam = {op: estimate_dinv_a_lambda_max(
        poisson_problem(2, 16, degree=3, device="cpu", operator=op).A)
        for op in ("banded", "kron")}
    assert abs(lam["banded"] - lam["kron"]) <= 1e-4 * lam["kron"]
