"""This slice end to end: the port's defect-correction solver
(``MixedPrecisionMG``), its residual-replacement PCG (``dwrr``), logger and
checkpoints against the JAX package's, on the CPU; and the headline's
default solver (twofloat defect correction) against the benchmark's plain
f64 reference on the benchmark's sources.

The reference runs eagerly (``jax.disable_jit``): XLA:CPU takes minutes to
compile the double-word graphs.  The port's ``lams`` are the reference's
estimates (the reference draws its power-iteration start vector from
``jax.random``).  On the CPU every kernel wrapper of the port runs its plain
version, which sums in the reference's order.
"""
import importlib
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.mixed import MixedPrecisionMG as RefMG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.mg.solver import MultigridSolver as RefSolver
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu.utils import checkpoint as ref_ckpt
from poms_tpu.utils.logging import ConvergenceLogger as RefLogger
from poms_tpu_torch import convert
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.utils import checkpoint as port_ckpt
from poms_tpu_torch.utils.logging import ConvergenceLogger

torch.set_num_threads(1)

TOL = 1e-10
CHEB = dict(nu1=1, nu2=1)
# (dim, n_el, degree, residual mode, inner cycles, tol).  The 2-level 16³
# p3 iteration slows to a factor 0.89 below 4e-9 and crosses 1e-10 at
# iteration 30 by 0.03 %, where a last bit decides the count; it is held to
# 5e-9, which lies 30 % from the entries on either side (7.3e-9, 3.8e-9).
CASES = [(3, 16, 3, "twofloat", 1, 5e-9), (3, 16, 3, "f64", 1, 5e-9),
         (2, 16, 2, "twofloat", 1, TOL), (2, 16, 2, "f64", 2, TOL),
         (2, 16, 2, "twofloat", 2, TOL)]


def _ref_cfg():
    return RefCycle(**CHEB, smoother=RefSmoother("chebyshev",
                                                 cheb_fraction=16.0))


def _cfg():
    return CycleConfig(**CHEB, smoother=SmootherConfig("chebyshev",
                                                       cheb_fraction=16.0))


def _solve_both(dim, n_el, degree, mode, inner, tol):
    with jax.disable_jit():
        rp = ref_problem(dim, n_el, degree=degree, operator="kron")
        ref = RefMG(rp, 2, _ref_cfg(), operator="kron", residual=mode,
                    inner_cycles=inner)
        lams = ref_lams(ref.levels64, ref.cfg.smoother)
        rres = ref.solve(tol=tol, maxiter=60)
    pp = poisson_problem(dim, n_el, degree=degree, device="cpu",
                         operator="kron")
    port = MixedPrecisionMG(pp, 2, _cfg(), operator="kron", residual=mode,
                            inner_cycles=inner)
    port.lams = convert.lams(lams)
    return ref, lams, rres, pp, port, port.solve(tol=tol, maxiter=60)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}d-n{c[1]}-p{c[2]}-{c[3]}-ic{c[4]}")
def solved(request):
    return request.param + _solve_both(*request.param)


def test_same_iterations_and_history(solved):
    """Equal iteration counts (6 at 16³, 7 and 4 in 2D), the history to
    rtol 1e-3 through entry 5 and 5e-3 after, in both modes.  The port and
    the reference differ in the f32 coarse triangular solves alone (4e-7
    relative); each correction carries that on (measured: up to 2.7e-4 by
    entry 1 in 2D, 8.8e-4 at entry 5 and 1.9e-3 at entry 6 in 3D)."""
    *_, rres, _, _, pres = solved
    assert rres.converged and pres.converged
    assert pres.iterations == rres.iterations, (pres.iterations,
                                                rres.iterations)
    assert pres.iterations == {(3, 1): 6, (2, 1): 7, (2, 2): 4}[
        solved[0], solved[4]]
    for i, (a, b) in enumerate(zip(pres.residuals, rres.residuals)):
        tol = 1e-3 if i <= 5 else 5e-3
        assert abs(a - b) <= tol * b, (i, a, b)


def test_converged_with_true_residual(solved):
    *_, tol, _, _, rres, pp, _, pres = solved
    assert pres.residuals[-1] <= tol
    r = pp.b.interior - pp.A.dot(pres.x).interior
    assert r.dtype == torch.float64
    assert float(torch.linalg.vector_norm(r)) <= 5 * tol
    want = np.asarray(rres.x.interior)
    assert want.dtype == np.float64
    assert (np.abs(pres.x.interior.numpy() - want).max()
            <= 1e-6 * np.abs(want).max())


def test_solve_compiled_matches_solve(solved):
    """As tests/test_mixed.py::test_solve_compiled_matches_host_loop: same
    count, tolerance reached, the solution to atol 1e-13."""
    _, _, _, mode, _, tol, *_, pp, port, pres = solved
    x, rn, it = port.solve_compiled(tol=tol, maxiter=60)
    assert it == pres.iterations
    assert float(rn) <= tol and float(rn) == pres.residuals[-1]
    np.testing.assert_allclose(x.interior.numpy(), pres.x.interior.numpy(),
                               rtol=0, atol=1e-13)
    x_int, _, _ = port.solve_compiled(tol=tol, maxiter=60, return_x=False)
    assert torch.equal(x_int, x.interior)
    if mode == "twofloat":
        from poms_tpu_torch.ops.twofloat import split_f64

        x2, _, it2 = port.solve_compiled(
            tol=tol, maxiter=60, b_pair=split_f64(pp.b.interior))
        assert it2 == it and torch.equal(x2.interior, x.interior)
    else:
        with pytest.raises(ValueError):
            port.solve_compiled(b_pair=(pp.b.interior, pp.b.interior))


def test_converted_solver_runs_the_reference_state(solved):
    """convert.mixed_precision_mg carries levels64/levels32, the split
    bands and the λ estimates: the converted solver's first corrections
    follow the reference's history to 1e-3 (its Cholesky factor is the
    reference's; the f32 triangular solves still differ)."""
    *_, ref, lams, rres, _, port, _ = solved
    conv = convert.mixed_precision_mg(ref, lams)
    assert conv.residual_mode == port.residual_mode
    assert conv.inner_cycles == port.inner_cycles
    assert conv.levels32[0].A.space.dtype == torch.float32
    assert conv.levels64[0].A.space.dtype == torch.float64
    assert conv.lams == port.lams and conv.cfg == port.cfg
    res = conv.solve(tol=TOL, maxiter=3)
    assert len(res.residuals) == 4
    for a, b in zip(res.residuals, rres.residuals):
        assert abs(a - b) <= 1e-3 * b, (a, b)


def test_auto_and_guards():
    kron = poisson_problem(1, 16, degree=2, device="cpu", operator="kron")
    banded = poisson_problem(1, 16, degree=2, device="cpu")
    assert MixedPrecisionMG(kron, 2, operator="kron").residual_mode \
        == "twofloat"
    assert MixedPrecisionMG(banded, 2).residual_mode == "f64"
    with pytest.raises(ValueError):
        MixedPrecisionMG(banded, 2, residual="twofloat")
    with pytest.raises(ValueError):
        MixedPrecisionMG(kron, 2, operator="kron", residual="f32")
    with pytest.raises(ValueError):       # the problem must be f64
        MixedPrecisionMG(poisson_problem(1, 16, degree=2, device="cpu",
                                         dtype=torch.float32), 2)
    # bf16 cycles are an option like any other (parity: test_torch_bf16.py)
    low = MixedPrecisionMG(kron, 2, operator="kron",
                           low_dtype=torch.bfloat16)
    assert low.levels32[0].A.space.dtype == torch.bfloat16
    res = low.solve(tol=TOL, maxiter=60)
    assert res.converged and res.x.interior.dtype == torch.float64
    with pytest.raises(ValueError, match="low_dtype"):
        MixedPrecisionMG(kron, 2, operator="kron", low_dtype=torch.float16)
    assert MixedPrecisionMG(kron, 2, operator="kron",
                            inner_cycles=0).inner_cycles == 1
    # the reference's guards are the same
    with pytest.raises(ValueError):
        RefMG(ref_problem(1, 16, degree=2), 2, residual="twofloat")


def test_banded_f64_defect_correction_matches_jax():
    """The banded operator (K2's plain version here) under the f64
    residual: 2D 16² p2, Jacobi-smoothed, against the jitted reference."""
    rcfg = RefCycle(smoother=RefSmoother("jacobi", 0.8))
    rres = RefMG(ref_problem(2, 16, degree=2), 2, rcfg).solve(tol=TOL,
                                                              maxiter=60)
    pp = poisson_problem(2, 16, degree=2, device="cpu")
    pres = MixedPrecisionMG(pp, 2, CycleConfig(
        smoother=SmootherConfig("jacobi", 0.8))).solve(tol=TOL, maxiter=60)
    assert pres.converged and pres.iterations == rres.iterations
    for i, (a, b) in enumerate(zip(pres.residuals, rres.residuals)):
        assert abs(a - b) <= (2e-3 if i <= 5 else 5e-2) * b, (i, a, b)


def test_dwrr_matches_jax():
    """Residual-replacement PCG at 16³ p3: the reference's iteration count
    (a multiple of replace_every = 3), the two-entry history, the tolerance
    reached on the true residual."""
    with jax.disable_jit():
        rp = ref_problem(3, 16, degree=3, operator="kron")
        ref = RefPCG(rp, 2, _ref_cfg(), operator="kron", precision="dwrr")
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=60)
    pp = poisson_problem(3, 16, degree=3, device="cpu", operator="kron")
    port = MGPreconditionedCG(pp, 2, _cfg(), operator="kron",
                              precision="dwrr")
    port.lams = convert.lams(lams)
    pres = port.solve(tol=TOL, maxiter=60)
    assert pres.converged and rres.converged
    assert pres.iterations == rres.iterations == 15
    assert pres.iterations % port.replace_every == 0
    assert len(pres.residuals) == 2 and pres.residuals[-1] <= TOL
    assert abs(pres.residuals[0] - rres.residuals[0]) <= 1e-12
    r = pp.b.interior - pp.A.dot(pres.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
    want = np.asarray(rres.x.interior)
    assert (np.abs(pres.x.interior.numpy() - want).max()
            <= 1e-6 * np.abs(want).max())
    x, rn, it = port.solve_compiled(tol=TOL, maxiter=60)
    assert it == pres.iterations and float(rn) == pres.residuals[-1]
    assert torch.equal(x.interior, pres.x.interior)


# -- logger and checkpoints ----------------------------------------------------

def _records(text):
    recs = [json.loads(line) for line in text.splitlines()]
    for rec in recs:
        rec.pop("elapsed_s", None)
    return recs


def test_logger_lines_equal_the_reference():
    """The same calls give the same JSON lines (``elapsed_s`` is a clock)."""
    out = []
    for cls in (RefLogger, ConvergenceLogger):
        buf = io.StringIO()
        with cls(stream=buf, meta={"dim": 3, "p": 3}) as log:
            log.log_cycle(cycle=1, residual=0.5, rho=0.25, wall_s=0.125)
            log.log_cycle(2, 1e-3, 2e-3, 0.5, note="x")
            log.close(converged=True, iterations=2)
        lines = buf.getvalue().splitlines()
        assert all("elapsed_s" in json.loads(l) for l in lines[1:3])
        out.append(_records(buf.getvalue()))
    assert out[0] == out[1]
    assert [r["event"] for r in out[1]] == ["start", "cycle", "cycle", "done"]


def test_logger_writes_a_file(tmp_path):
    path = tmp_path / "log.jsonl"
    log = ConvergenceLogger(path=str(path))
    log.log_cycle(1, 0.5, 0.5, 0.1)
    log.close()
    assert _records(path.read_text()) == [
        {"event": "cycle", "cycle": 1, "residual": 0.5, "rho": 0.5,
         "wall_s": 0.1}]


@pytest.mark.parametrize("solver", ["mg", "pcg-f64", "pcg-dw", "mixed-tf",
                                    "mixed-f64"])
def test_solve_logs_every_iteration(solver):
    """``solve(logger=...)`` in all three solvers: one record per
    iteration, residuals and ratios those of the history."""
    pp = poisson_problem(2, 16, degree=2, device="cpu", operator="kron")
    make = {
        "mg": lambda: MultigridSolver(pp, 2, _cfg(), operator="kron"),
        "pcg-f64": lambda: MGPreconditionedCG(pp, 2, _cfg(),
                                              operator="kron"),
        "pcg-dw": lambda: MGPreconditionedCG(pp, 2, _cfg(), operator="kron",
                                             precision="dw"),
        "mixed-tf": lambda: MixedPrecisionMG(pp, 2, _cfg(),
                                             operator="kron"),
        "mixed-f64": lambda: MixedPrecisionMG(pp, 2, _cfg(), operator="kron",
                                              residual="f64")}[solver]
    buf = io.StringIO()
    with ConvergenceLogger(stream=buf, meta={"solver": solver}) as log:
        res = make().solve(tol=TOL, maxiter=40, logger=log)
    recs = _records(buf.getvalue())
    assert recs[0] == {"event": "start", "solver": solver}
    cyc = recs[1:]
    assert res.converged and len(cyc) == res.iterations
    assert [c["cycle"] for c in cyc] == list(range(1, res.iterations + 1))
    assert [c["residual"] for c in cyc] == res.residuals[1:]
    for c, a, b in zip(cyc, res.residuals, res.residuals[1:]):
        assert c["rho"] == b / a and c["wall_s"] > 0


def test_mg_logger_matches_the_reference_solver():
    """The same 1D solve logged by both packages: the same records up to
    the clocks and the residuals' rounding (1e-4 relative: the last entries
    lie at the f64 floor of the iteration, 1e-9 of ‖b‖)."""
    buf_r, buf_p = io.StringIO(), io.StringIO()
    rmg = RefSolver(ref_problem(1, 16, degree=2), num_levels=2,
                    cfg=RefCycle(smoother=RefSmoother("jacobi", 0.8)))
    rmg.solve(tol=TOL, maxiter=40, logger=RefLogger(stream=buf_r))
    pmg = MultigridSolver(poisson_problem(1, 16, degree=2, device="cpu"), 2,
                          CycleConfig(smoother=SmootherConfig("jacobi", 0.8)))
    pmg.solve(tol=TOL, maxiter=40, logger=ConvergenceLogger(stream=buf_p))
    ref, port = _records(buf_r.getvalue()), _records(buf_p.getvalue())
    assert len(ref) == len(port) > 0
    for a, b in zip(ref, port):
        assert a.keys() == b.keys() and a["cycle"] == b["cycle"]
        assert abs(a["residual"] - b["residual"]) <= 1e-4 * a["residual"]


def test_checkpoint_files_equal_the_reference(tmp_path):
    """Both packages write the same arrays and read each other's files; the
    port also takes a tensor."""
    x = np.random.default_rng(0).standard_normal((5, 7))
    hist, meta = [1.0, 0.1, 0.01], {"dim": 2, "p": 3}
    ref_path, port_path = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    ref_ckpt.save_solver_state(ref_path, x, hist, 3, meta=meta)
    port_ckpt.save_solver_state(port_path, torch.from_numpy(x), hist, 3,
                                meta=meta)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for load, path in ((port_ckpt.load_solver_state, ref_path),
                       (ref_ckpt.load_solver_state, port_path)):
        x2, hist2, it, meta2 = load(path)
        np.testing.assert_array_equal(x2, x)
        assert hist2 == hist and it == 3 and meta2 == meta


def test_checkpoint_resume_continues_solve(tmp_path):
    """Interrupt after 4 cycles, resume from the file: the same history."""
    from poms_tpu_torch.core.vector import StencilVector

    prob = poisson_problem(2, 16, degree=2, device="cpu")
    mg = MultigridSolver(prob, 2, CycleConfig(
        smoother=SmootherConfig("jacobi", 0.8)))
    full = mg.solve(tol=TOL, maxiter=40)
    part = mg.solve(tol=TOL, maxiter=4)
    path = str(tmp_path / "ck.npz")
    port_ckpt.save_solver_state(path, part.x.interior, part.residuals,
                                part.iterations)
    x_in, hist, it, _ = port_ckpt.load_solver_state(path)
    rest = mg.solve(tol=TOL, maxiter=40 - it,
                    x0=StencilVector.from_interior(prob.space, x_in))
    np.testing.assert_allclose(hist + rest.residuals[1:], full.residuals,
                               rtol=1e-10)


# -- the headline's default solver against the benchmark's plain reference ---

REPO = Path(__file__).resolve().parent.parent
# 16³ (2 levels) and 32³ (3), by the headline example's levels rule
HEADLINE_SIZES = (16, 32)
# smooth4's four sources, then a seeded random smooth one
HEADLINE_SOURCES = (0, 1, 2, 3, "random")


def _benchmark_reference():
    """The benchmark's ``poisson`` reference kind (its bands from NumPy, A
    applied in f64 by plain PyTorch products; neither package) and the
    ``smooth4`` traffic's sources."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    kind = importlib.import_module("benchmark.reference.kinds.poisson")
    sources = json.loads((REPO / "benchmark/traffic/smooth4.json")
                         .read_text())["sources"]
    return kind, sources


@pytest.fixture(scope="module", params=HEADLINE_SIZES,
                ids=lambda n: f"n{n}")
def headline_dc(request):
    """(problem entry, problem, the headline example's default solver, the
    reference kind, the sources) at one size."""
    from poms_tpu_torch.examples.headline_solve import build

    n = request.param
    prob, mg = build(n, 3, "dc", device="cpu")
    assert mg.residual_mode == "twofloat"
    assert mg.cfg.smoother.cheb_fraction == 32.0
    return ({"n_el": n, "degree": 3}, prob, mg) + _benchmark_reference()


def _random_smooth(kind, problem, seed, modes=4):
    """Σ c·s_a⊗s_b⊗s_c over the modes 1…``modes`` on each axis, c drawn
    from the seed, scaled as the traffic's sources are.  A random field of
    every frequency (white noise) is not used: the V-cycle of cubic splines
    damps its roughest modes by about 0.88 a correction at 16³, with f64
    residuals as with twofloat ones (the same history to three digits), so
    it needs some 170 corrections, the cycle's rate and not the precision."""
    g = torch.Generator().manual_seed(seed)
    s = torch.stack([torch.as_tensor(kind.load(problem, m))
                     for m in range(1, modes + 1)])
    c = torch.randn(modes, modes, modes, generator=g, dtype=torch.float64)
    b = torch.einsum("abc,ai,bj,ck->ijk", c, s, s, s)
    return b * (kind.target_norm(problem) / float(torch.linalg.vector_norm(b)))


def _pool_slot(kind, problem, sources, seed, k):
    """Slot ``k`` of the benchmark's pool for ``seed`` (its
    ``reference/rhs.py``)."""
    from benchmark.reference import rhs
    return rhs.one(kind, problem, sources, seed, k, "cpu")


@pytest.mark.parametrize("source", HEADLINE_SOURCES, ids=str)
def test_headline_dc_meets_the_plain_reference(headline_dc, source):
    """The headline example's default solver (twofloat defect correction,
    one f32 Chebyshev(4) V-cycle over [λmax/32, λmax] a correction) reaches
    ‖b − A·x‖₂ ≤ 1e-10 by the benchmark's f64 reference operator on each of
    the benchmark's sources; x without its low word does not.

    Dropping xl rounds each value of x to f32, an error of up to 2⁻²⁵ of
    itself at every point and rough from point to point, which A's largest
    eigenvalues amplify: it leaves ‖b − A·xh‖₂ at 4.7e-9 to 2.8e-8 on these
    ten cases, 47 to 280 times the tolerance, against the twofloat
    solution's 8e-11 to 1e-10.  So 1e-10 tells twofloat from f32, and the
    test holds xh to 10 times it."""
    from poms_tpu_torch.core.vector import StencilVector

    problem, prob, mg, kind, sources = headline_dc
    if source == "random":
        b = _random_smooth(kind, problem, seed=2 ** 31 + 5)
    else:
        b = _pool_slot(kind, problem, sources, seed=2 ** 31 + 17, k=source)
    x, rn, it = mg.solve_compiled(StencilVector.from_interior(prob.space, b),
                                  tol=TOL, maxiter=100, return_x=False)
    assert float(rn) <= TOL and it < 100
    A = kind.operator(problem, "cpu")
    true = float(torch.linalg.vector_norm(b - A.apply(x)))
    assert true <= TOL, (it, true)
    xh = x.to(torch.float32).to(torch.float64)
    dropped = float(torch.linalg.vector_norm(b - A.apply(xh)))
    assert dropped > 10 * TOL, (
        f"‖b − A·xh‖₂ = {dropped:.3e}: x's high word alone should miss "
        f"1e-10 by more than 10×")
