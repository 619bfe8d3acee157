"""K1's plans fold terms that share their bands on every axis but one
(``ops/kron.py::fold_terms``): the periodic shifted operator
σ·M⊗M⊗M + K⊗M⊗M + M⊗K⊗M + M⊗M⊗K becomes (σM + K)⊗M⊗M + M⊗K⊗M + M⊗M⊗K,
one run of terms a K1 call where it took two, while the operator keeps its
four terms and K5 its four histories; an operator with no such pair gets
the plan it had, bit for bit.  On the CPU (the card's kernels against their
plain versions: tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.periodic import periodic_problem
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import counters
from poms_tpu_torch.ops.kron import (_lift_labels, build_kron_plan,
                                     chunk_terms, fold_terms,
                                     k1r_passes_plain, kron_mode,
                                     kron_mode_plain, plan_apply,
                                     sharing_plan)

torch.set_num_threads(1)

# grids of the periodic operators, 1D to 3D (no two axes alike)
NPTS = {1: (40,), 2: (14, 18), 3: (12, 14, 16)}
TOL = {64: 1e-13, 32: 1e-6}
KEY = "kron.folded_terms"


def _periodic(dim, degree, bits=64):
    """The periodic shifted operator; in f32 cast as ``mg/mixed.py`` casts a
    level (one cast a distinct band, so the sharing holds)."""
    prob = periodic_problem(dim, NPTS[dim], degree=degree, operator="kron",
                            device="cpu")
    if bits == 64:
        return prob.A
    return KroneckerSumOperator(prob.space.with_dtype(torch.float32),
                                prob.A.terms)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("degree", [3, 5], ids=["k1", "k1r"])
@pytest.mark.parametrize("bits", [64, 32])
def test_folded_modes_equal_the_unfolded_chain(dim, degree, bits):
    """Every mode of the folded plan (its plain chain, the plan's control
    data executed, K1r's three plain passes at degree 5) equals the plain
    chain of the operator's unfolded terms with their own diagonal: to
    1e-13 of max|y| in f64, f32 rounding in f32."""
    A = _periodic(dim, degree, bits)
    plan, sp = A.plan, A.space
    assert len(A.terms) == dim + 1 and plan.n_terms == dim
    assert len(plan.chunks) == 1 and plan.runtime == (degree == 5)
    rng = np.random.default_rng(dim + degree)
    x, b, d = (torch.as_tensor(rng.standard_normal(sp.npts),
                               dtype=sp.dtype) for _ in range(3))
    diag = A.diagonal()
    assert _rel(plan.diagonal(), diag) <= TOL[bits]
    for mode, kw in (("apply", {}), ("residual", {"b": b}), ("dinv", {}),
                     ("cheb", {"b": b, "d": d, "c1": 0.3, "c2": 0.7}),
                     ("cheb", {"b": b, "c2": 0.7})):
        want = kron_mode_plain(mode, A.terms, x, sp.npts, sp.pads,
                               sp.periodic, diag=diag, **kw)
        got = [kron_mode(mode, plan, x, **kw)]
        if plan.runtime:
            got.append(k1r_passes_plain(mode, plan, x, **kw))
        if mode == "apply":
            got.append(plan_apply(plan, x))
        for g in got:
            for gi, wi in zip(g if mode == "cheb" else (g,),
                              want if mode == "cheb" else (want,)):
                assert gi.dtype == sp.dtype
                assert _rel(gi, wi) <= TOL[bits], mode


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("degree", [3, 5])
@pytest.mark.parametrize("bits", [64, 32])
def test_dirichlet_plans_are_the_unfolded_ones(dim, degree, bits):
    """No two terms of the Dirichlet operator share two axes' bands: its
    plan is, in terms, labels, stacked bands, centre columns, runs and
    tiling, the one built with the fold off, and the counter stays."""
    before = counters.snapshot()[KEY]
    A = poisson_problem(dim, 12, degree=degree, operator="kron",
                        device="cpu").A
    if bits == 32:
        A = KroneckerSumOperator(A.space.with_dtype(torch.float32), A.terms)
    assert counters.snapshot()[KEY] == before
    sp, plan = A.space, A.plan
    off = build_kron_plan(A.terms, sp.npts, sp.pads, sp.periodic, fold=False)
    assert all(a is b for ta, tb in zip(plan.terms, off.terms)
               for a, b in zip(ta, tb))
    assert len(plan.terms) == len(off.terms) == dim
    assert plan.labels == off.labels and plan.chunks == off.chunks
    assert plan.plans == off.plans
    assert (plan.P, plan.runtime, plan.tiling, plan.trows, plan.tcols) == \
        (off.P, off.runtime, off.tiling, off.trows, off.tcols)
    for mine, theirs in ((plan.bands, off.bands), (plan.cols, off.cols)):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert torch.equal(plan.diagonal(), off.diagonal())


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", ["periodic", "dirichlet"])
def test_the_folded_terms_counter(dim, kind):
    """``kron.folded_terms`` adds the terms a plan's fold removed: 1 for
    the periodic shifted operator in 1D, 2D and 3D (2 → 1, 3 → 2, 4 → 3
    terms), 0 for the Dirichlet one."""
    make = periodic_problem if kind == "periodic" else poisson_problem
    before = counters.snapshot()[KEY]
    prob = make(dim, 16, degree=3, operator="kron", device="cpu")
    assert counters.snapshot()[KEY] - before == (kind == "periodic")
    assert prob.A.plan.n_terms == len(prob.A.terms) - (kind == "periodic")


def _bands(n, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype)
            for _ in range(5)]


def test_the_fold_rule():
    """Pairs fold where they differ on exactly one axis, in order, again
    until none does; a fold that would take more runs of K1's caps is not
    kept; equal terms do not fold (they share every partial already)."""
    X, Y, M, K, _ = _bands(6, 0)
    # X M M + Y M M would open a third axis-0 band: two runs, not kept;
    # Y M M + Y K M folds on axis 1 in one run
    terms = [[X, M, M], [Y, M, M], [X, K, K], [Y, K, M]]
    labels = [[0, 1, 0, 1], [0, 0, 1, 1], [0, 0, 1, 0]]
    assert len(chunk_terms(_lift_labels(labels))) == 1
    folded, lab = fold_terms(terms, labels)
    assert len(folded) == 3 and len(chunk_terms(_lift_labels(lab))) == 1
    assert folded[0] == tuple(terms[0]) and folded[2] == tuple(terms[2])
    assert folded[1][0] is Y and folded[1][2] is M
    assert torch.equal(folded[1][1], M + K)
    assert lab == [[0, 1, 0], [0, 1, 2], [0, 0, 1]]
    # equal terms stay two; a pair of distinct terms in 1D always folds
    same = [[X, M, M], [X, M, M]]
    assert fold_terms(same, [[0, 0]] * 3) == (
        [tuple(t) for t in same], [[0, 0]] * 3)
    assert len(fold_terms([[X], [Y], [M]], [[0, 1, 2]])[0]) == 1
    # nothing to fold: the same band objects and labels come back
    pois = [[K, M, M], [M, K, M], [M, M, K]]
    lab = [[0, 1, 1], [0, 1, 0], [0, 0, 1]]
    assert fold_terms(pois, lab) == ([tuple(t) for t in pois], lab)


def test_folded_bands_are_summed_in_f64_and_rounded_once():
    """f32 and bf16 bands: the folded band is their f64 sum rounded once,
    also where three terms fold into one (not two roundings)."""
    for dtype in (torch.float32, torch.bfloat16):
        A, B, C, _, _ = _bands(50, 1, dtype)
        folded, lab = fold_terms([[A], [B], [C]], [[0, 1, 2]])
        want = (A.double() + B.double() + C.double()).to(dtype)
        assert lab == [[0]] and folded[0][0].dtype == dtype
        assert torch.equal(folded[0][0], want)


def _cfg():
    return CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))


def test_every_level_folds_and_k5_keeps_four_histories():
    """The periodic dw-PCG (16³ p3, 2 levels): every K1 plan of its
    hierarchy, f64 and the f32 cycle's, is the folded three-term one while
    each operator keeps its four terms; K5's plan keeps the four terms'
    labels and four histories in one run; the solve converges and takes
    the iterations of the same solver with its K1 plans unfolded."""
    prob = periodic_problem(3, 16, degree=3, operator="kron", device="cpu")
    sol = MGPreconditionedCG(prob, 2, _cfg(), operator="kron",
                             precision="dw")
    plans = [lev.A.plan for lev in sol.levels + sol.levels_pre]
    assert len(plans) == 4 and {p.dtype for p in plans} == {torch.float64,
                                                           torch.float32}
    for lev in sol.levels + sol.levels_pre:
        assert len(lev.A.terms) == 4 and lev.A.plan.n_terms == 3
        assert len(lev.A.plan.chunks) == 1
    k5 = sol._plan_df
    assert k5.n_terms == 4 and k5.labels == _lift_labels(
        prob.A._band_labels())
    assert k5.chunks == [[0, 1, 2, 3]]
    assert len(sharing_plan(k5.labels)["w_src"]) == 4
    folded = sol.solve(tol=1e-10, maxiter=40)
    for lev in sol.levels + sol.levels_pre:
        sp = lev.A.space
        lev.A.plan = build_kron_plan(lev.A.terms, sp.npts, sp.pads,
                                     sp.periodic, fold=False)
        assert lev.A.plan.n_terms == 4 and len(lev.A.plan.chunks) == 2
    unfolded = sol.solve(tol=1e-10, maxiter=40)
    assert folded.converged and unfolded.converged
    assert folded.iterations == unfolded.iterations
    r = prob.b.interior - prob.A.dot(folded.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 1e-10
