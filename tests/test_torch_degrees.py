"""Spline degrees 4-8 (K1r's and K5r's half-widths) on the CPU against the
JAX package, the route each degree's plans take, and the refusals above
them.

Every input is drawn from numpy seeds and goes through the JAX function and
the port's wrapper, which runs its plain version for CPU tensors.  K1's
modes are held to K1's tolerances (f32 1e-6 of max|y|, f64 1e-13: the
summation order is the only difference), bf16 K1 two-sidedly against f64
(the port within 2⁻⁸·S, the reference's bf16 ``dot`` within K·2⁻⁸·S, as in
tests/test_torch_bf16.py), the double-word residual within 1e-13 of max|r|
(the JAX side may contract a multiply-add).  K5's launch plan (bands padded
to the compiled half-width, terms in runs chained through the sum so far)
is executed in plain PyTorch and must give the single pass's words.  The
solvers run with the reference's λ estimates to a tolerance that lies
between two entries of the histories, so both take the same count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poms_tpu.core.kron import KroneckerSumOperator as RefKron
from poms_tpu.core.space import StencilVectorSpace as RefSpace
from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.mixed import MixedPrecisionMG as RefMG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models.periodic import periodic_problem as ref_periodic
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu.ops import twofloat as ref_tf
from poms_tpu_torch import convert
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.examples import headline_solve
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.periodic import periodic_problem
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import kron as k1
from poms_tpu_torch.ops import twofloat as tf
from poms_tpu_torch.ops.stencil import K2_SMEM, k2_lift, k2_plan
from poms_tpu_torch.ops.stencil_v2 import k3_smem_bytes, tile_v2

torch.set_num_threads(1)

DEGREES = (5, 6, 7, 8)
TOL = {32: 1e-6, 64: 1e-13}
DT = {32: (jnp.float32, torch.float32), 64: (jnp.float64, torch.float64)}
BF16 = torch.bfloat16
EPS = 2.0 ** -8


def _shapes(p):
    """A 1D, a 2D (mixed periodic) and a 3D (ragged) grid for half-width p:
    every axis holds its band (periodic: n > 2p)."""
    return [((3 * p + 7,), (True,)),
            ((2 * p + 5, 2 * p + 9), (False, True)),
            ((p + 4, p + 6, 2 * p + 3), (False,) * 3)]


def _bands(npts, p, seed):
    """Poisson-shaped K and M bands per axis with a dominant centre column
    (the diagonal divides in dinv and cheb), and three fields."""
    rng = np.random.default_rng(seed)

    def band(n):
        return (rng.standard_normal((n, 2 * p + 1)) / 4
                + 2.0 * (np.arange(2 * p + 1) == p))

    return ([band(n) for n in npts], [band(n) for n in npts],
            [rng.standard_normal(npts) for _ in range(3)])


def _terms(Ks, Ms):
    d = len(Ks)
    return [[Ks[b] if b == a else Ms[b] for b in range(d)] for a in range(d)]


def _rel(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- K1's modes at degrees 5-8 -------------------------------------------------

@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("shape", [0, 1, 2])
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("mode", ["apply", "residual", "dinv", "cheb"])
def test_k1_modes_match_jax(degree, shape, bits, mode):
    npts, periodic = _shapes(degree)[shape]
    pads = (degree,) * len(npts)
    Ks, Ms, fields = _bands(npts, degree, seed=10 * degree + shape)
    jdt, tdt = DT[bits]
    ref = RefKron(RefSpace(npts=npts, pads=pads, periodic=periodic,
                           dtype=jdt),
                  _terms([jnp.asarray(K, jdt) for K in Ks],
                         [jnp.asarray(M, jdt) for M in Ms]))
    op = KroneckerSumOperator(
        StencilVectorSpace(npts=npts, pads=pads, periodic=periodic,
                           dtype=tdt, device="cpu"),
        _terms([torch.as_tensor(K, dtype=tdt) for K in Ks],
               [torch.as_tensor(M, dtype=tdt) for M in Ms]))
    assert op.plan.P == degree and op.plan.runtime   # K1r from 4 on
    xj, bj, dj = (jnp.asarray(f, jdt) for f in fields)
    xt, bt, dt = (torch.as_tensor(f, dtype=tdt) for f in fields)
    ax = ref.dot(RefVec.from_interior(ref.space, xj)).interior
    if mode == "apply":
        pairs = [(op._apply_interior(xt), ax)]
    elif mode == "residual":
        sp = op.space
        pairs = [(op.residual(StencilVector.from_interior(sp, xt),
                              StencilVector.from_interior(sp, bt)),
                  bj - ax)]
    elif mode == "dinv":
        pairs = [(op.dinv_apply(xt), ax / ref.diagonal())]
    else:
        c1, c2 = 0.375, 0.75
        z = (bj - ax) / ref.diagonal()
        x_new, d_new = op.cheb_update(xt, bt, dt.clone(), c1, c2)
        pairs = [(d_new, c1 * dj + c2 * z), (x_new, xj + c1 * dj + c2 * z)]
    for got, want in pairs:
        assert tuple(got.shape) == npts
        assert _rel(got, want) <= TOL[bits]


# -- bf16 K1 at degrees 5 and 8 -----------------------------------------------

def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _jnp16(t: torch.Tensor):
    return jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(t.astype(jnp.float32), np.float64)


@pytest.mark.parametrize("degree", [5, 8])
@pytest.mark.parametrize("shape", [1, 2])
def test_k1_bf16_port_and_jax_against_f64(degree, shape):
    """The bf16 plain version the kernel is held to (f32 arithmetic, one
    rounding) within 2⁻⁸·S of f64, the reference's bf16 ``dot`` within
    K·2⁻⁸·S, S = |A|·|x| (+ |b|), K the taps it adds and rounds."""
    npts, periodic = _shapes(degree)[shape]
    pads = (degree,) * len(npts)
    Ks, Ms, fields = _bands(npts, degree, seed=degree + shape)
    terms = _terms([_bf16(K) for K in Ks], [_bf16(M) for M in Ms])
    cast = {}
    rterms = [[cast.setdefault(id(B), _jnp16(B)) for B in term]
              for term in terms]
    port = KroneckerSumOperator(
        StencilVectorSpace(npts=npts, pads=pads, periodic=periodic,
                           dtype=BF16, device="cpu"), terms)
    assert port.plan.P == degree
    ref = RefKron(RefSpace(npts=npts, pads=pads, periodic=periodic,
                           dtype=jnp.bfloat16), rterms)
    x, b = (_bf16(f) for f in fields[:2])
    hi = [[B.to(torch.float64) for B in term] for term in terms]
    ax = k1.kron_apply_plain(hi, x.double(), npts, pads, periodic).numpy()
    mag = k1.kron_apply_plain([[B.abs() for B in t] for t in hi],
                              x.double().abs(), npts, pads,
                              periodic).numpy()
    K = len(terms) * sum(2 * p + 1 for p in pads) + 2
    rax = ref.dot(RefVec.from_interior(ref.space, _jnp16(x))).interior
    b64 = _f64(b)
    sp = port.space
    for got, want, exact, S in (
            (port._apply_interior(x), rax, ax, mag),
            (port.residual(StencilVector.from_interior(sp, x),
                           StencilVector.from_interior(sp, b)),
             _jnp16(b) - rax, b64 - ax, mag + np.abs(b64))):
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert (np.abs(_f64(got) - exact) <= EPS * S).all()
        assert (np.abs(_f64(want) - exact) <= K * EPS * S).all()


# -- K5 at degrees 6 and 8 ------------------------------------------------------

@pytest.mark.parametrize("dim,n_el,degree", [(3, 6, 6), (2, 10, 6),
                                             (3, 5, 8), (1, 20, 8)])
def test_residual_kron_df_matches_jax(dim, n_el, degree):
    """The double-word residual of the Poisson operator within 1e-13 of
    max|r| of the JAX one, and near the f64 residual."""
    rp = ref_problem(dim, n_el, degree=degree, operator="kron")
    pp = convert.problem(rp)
    rng = np.random.default_rng(degree)
    x = rng.standard_normal(rp.space.npts)
    xj, xt = jnp.asarray(x), torch.from_numpy(x.copy())
    tdf = [[ref_tf.split_f64(B) for B in term] for term in rp.A.terms]
    rj = ref_tf.merge_f64(*ref_tf.residual_kron_df(
        tdf, *ref_tf.split_f64(rp.b.interior), *ref_tf.split_f64(xj),
        rp.space.pads))
    seen = {}
    pdf = [[seen.setdefault(id(B), tf.split_f64(B)) for B in term]
           for term in pp.A.terms]
    rt = tf.merge_f64(*tf.residual_kron_df(
        pdf, *tf.split_f64(pp.b.interior), *tf.split_f64(xt),
        pp.space.pads))
    assert _rel(rt, rj) <= 1e-13
    r64 = pp.b.interior - pp.A._apply_interior(xt)
    assert _rel(rt, r64.numpy()) <= 1e-12


def _plan_residual_df(plan, bh, bl, xh, xl, negate=False):
    """K5's launches in plain PyTorch: the plan's stacked bands (zero-padded
    to its half-width), lifted geometry and runs of terms, one run after
    another, each run's terms added onto the sum of the runs before it and
    the last forming b − sum (``negate``: −(b − sum)), as the kernel does."""
    P, per = plan.P, plan.per3
    bands = list(zip(plan.bands, plan.bands_lo))
    x3 = (xh.reshape(plan.n3), xl.reshape(plan.n3))
    band_df = tf._apply_band_1d_axis_df
    axh = axl = None
    for sp in plan.plans:
        u = [band_df(*(B[lab] for B in bands[2]), *x3, 2, P, per[2])
             for lab in sp["u_lab"]]
        v = [band_df(*(B[lab] for B in bands[1]), *u[src], 1, P, per[1])
             for src, lab in zip(sp["v_src"], sp["v_lab"])]
        w = [band_df(*(B[lab] for B in bands[0]), *v[src], 0, P, per[0])
             for src, lab in zip(sp["w_src"], sp["w_lab"])]
        for k in sp["term_w"]:
            if axh is None:
                axh, axl = w[k]
            else:
                axh, axl = tf.dw_add(axh, axl, *w[k])
    rh, rl = tf.dw_add(bh.reshape(plan.n3), bl.reshape(plan.n3), -axh, -axl)
    if negate:
        rh, rl = tf.dw_neg(rh, rl)
    return rh.reshape(plan.npts), rl.reshape(plan.npts)


def _split_terms(terms):
    seen = {}
    return [[seen.setdefault(id(B), tf.split_f64(torch.as_tensor(B)))
             for B in term] for term in terms]


@pytest.mark.parametrize("nterms", [5, 6])
@pytest.mark.parametrize("p", [2, 6, 8])
@pytest.mark.parametrize("negate", [False, True])
def test_k5_chained_runs_equal_the_single_pass(nterms, p, negate):
    """An operator of 5 or 6 terms sharing nothing takes runs of at most 2
    u partials (3 runs, on the compiled K5 at 2 and on K5r at 6 and 8);
    their chain through the double-word sum of the terms so far gives the
    single pass's words bit for bit."""
    rng = np.random.default_rng(nterms + p)
    npts = (p + 3, p + 4, p + 5)
    terms = _split_terms([[rng.standard_normal((n, 2 * p + 1))
                           for n in npts] for _ in range(nterms)])
    plan = tf.build_kron_df_plan(terms, npts, (p,) * 3)
    assert plan.chunks == [[0, 1], [2, 3], list(range(4, nterms))]
    assert plan.P == p and plan.runtime == (p > 3)   # no tap padded
    (xh, xl), (bh, bl) = (tf.split_f64(torch.from_numpy(
        rng.standard_normal(npts))) for _ in range(2))
    got = _plan_residual_df(plan, bh, bl, xh, xl, negate)
    want = tf.residual_kron_df_plain(terms, bh, bl, xh, xl, (p,) * 3,
                                     negate=negate)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("npts,degree", [((9, 10, 11), 4), ((11, 12, 15), 6),
                                         ((12, 13, 17), 7), ((13, 14, 19), 8),
                                         ((25, 30), 8), ((60,), 7)])
@pytest.mark.parametrize("periodic", [False, True])
def test_k5_plan_equals_the_single_pass(npts, degree, periodic):
    """The Poisson-shaped operator (2 u, 3 v, 3 histories) at K5's new
    half-widths, 3D and lifted from 2D and 1D (a lifted axis: a band of
    the compiled width with its centre alone set): the plan's run gives the
    plain version's words; a zero tap adds (0, 0), which leaves a
    normalised pair as it was."""
    Ks, Ms, fields = _bands(npts, degree, seed=degree)
    terms = _split_terms(_terms(Ks, Ms))
    pads, per = (degree,) * len(npts), (periodic,) * len(npts)
    plan = tf.build_kron_df_plan(terms, npts, pads, per)
    assert len(plan.chunks) == 1 and plan.P == degree
    (xh, xl), (bh, bl) = (tf.split_f64(torch.from_numpy(f))
                          for f in fields[:2])
    got = _plan_residual_df(plan, bh, bl, xh, xl, True)
    want = tf.residual_kron_df_plain(terms, bh, bl, xh, xl, pads,
                                     periodic=per, negate=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_two_prod_is_exact_where_the_split_cascade_rounds():
    """Pairs from K5 at degree 7 (133³) on which the 12|12-bit split form
    (the JAX package's) rounds its error sum: the port's two_prod, like
    the kernel's FMA, returns p + e == a·b exactly there."""
    a = np.array([6.429567813873291, 5.974346570166182e-15,
                  6.429567813873291], np.float32)
    b = np.array([-0.0012753164628520608, 0.641238272190094,
                  -6.227131166269828e-07], np.float32)
    exact = a.astype(np.float64) * b.astype(np.float64)
    p, e = tf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(),
                                  exact)
    rp, re = ref_tf.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))
    split_sum = np.asarray(rp, np.float64) + np.asarray(re, np.float64)
    assert (split_sum != exact).all()


@pytest.mark.parametrize("n", [134, 70, 38, 22])
@pytest.mark.parametrize("P", [4, 6, 7, 8])
def test_k5_wide_tiling_fits_a_block(n, P):
    """At the half-widths of degrees 4-8, which run on K5r, K5r's launch
    shape gives every pass a block whose shared memory fits the card, with
    3 and 4 histories; at 3 the compiled K5 keeps its own model, and no
    compiled tiling holds half-width 40."""
    for histories in (3, 4):
        TL, *warps = k1.runtime_tiling(
            (n,) * 3, P, tf.k5_step_cost(P, histories, runtime=True),
            max_cols=k1.LANES)
        assert TL == k1.LANES and all(w in k1.RT_WARPS for w in warps)
        need = [tf.k5r_pass_smem(P, p, w) for p, w in zip(k1.RT_PASSES,
                                                           warps)]
        assert max(need) <= K2_SMEM, (n, P, histories, warps, need)
    assert k1.kron_tiling((129,) * 3, 3, tf.MAX_THREADS_DW,
                          tf.k5_step_cost(3, rows=2), rows=2) == (26, 19, 22)
    with pytest.raises(ValueError, match="fits a block"):
        k1.kron_tiling((n,) * 3, 40, tf.MAX_THREADS_DW, tf.k5_step_cost(40))


# -- the solvers at degrees 6 and 8 -----------------------------------------------

# (kind, dim, n_el, degree, tol): each tol lies between two entries of the
# histories, at least 20% from either, so the count does not hang on a bit
SOLVES = [("pcg", 3, 16, 6, 2.5e-6), ("dc", 3, 16, 6, 5e-6),
          ("pcg", 2, 32, 8, 2.5e-6), ("dc", 2, 32, 8, 8e-5)]


@pytest.fixture(scope="module", params=SOLVES,
                ids=lambda c: f"{c[0]}-{c[1]}d-n{c[2]}-p{c[3]}")
def solved(request):
    """The reference (eagerly: XLA:CPU compiles the double-word graphs for
    minutes) and the port with its λ estimates."""
    kind, dim, n_el, degree, tol = request.param
    with jax.disable_jit():
        rp = ref_problem(dim, n_el, degree=degree, operator="kron")
        cfg = RefCycle(nu1=1, nu2=1, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0))
        if kind == "pcg":
            ref = RefPCG(rp, 2, cfg, mixed=True, operator="kron",
                         precision="dw")
            lams = ref_lams(ref.levels, ref.cfg.smoother)
        else:
            ref = RefMG(rp, 2, cfg, operator="kron", residual="twofloat")
            lams = ref_lams(ref.levels64, ref.cfg.smoother)
        rres = ref.solve(tol=tol, maxiter=40)
    pp = poisson_problem(dim, n_el, degree=degree, device="cpu",
                         operator="kron")
    pcfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    if kind == "pcg":
        port = MGPreconditionedCG(pp, 2, pcfg, mixed=True, operator="kron",
                                  precision="dw")
    else:
        port = MixedPrecisionMG(pp, 2, pcfg, operator="kron",
                                residual="twofloat")
    port.lams = convert.lams(lams)
    return request.param, rres, pp, port, port.solve(tol=tol, maxiter=40)


def test_solver_counts_match_jax(solved):
    (kind, _, _, degree, tol), rres, pp, port, pres = solved
    assert rres.converged and pres.converged
    assert pres.iterations == rres.iterations, (pres.iterations,
                                                rres.iterations)
    for a, b in zip(pres.residuals, rres.residuals):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    # the tol lies well inside a gap of the history
    h = pres.residuals
    assert h[-1] <= tol / 1.2 and h[-2] >= tol * 1.2, h[-3:]
    assert port._plan_df.P == degree      # K5r, at the degree itself


def test_solver_solve_compiled_matches_solve(solved):
    (_, _, _, _, tol), _, _, port, pres = solved
    x, rn, it = port.solve_compiled(tol=tol, maxiter=40)
    assert it == pres.iterations and float(rn) == pres.residuals[-1]
    assert torch.equal(x.interior, pres.x.interior)


@pytest.mark.parametrize("solver", ["pcg", "dc"])
@pytest.mark.parametrize("degree", range(1, 13))
def test_headline_example_routes_each_degree_by_its_half_width(degree,
                                                               solver):
    """The headline example's solvers at every degree 1-12 (8³ elements):
    K5's plan and every cycle level's K1 plan at the degree padded to the
    first compiled half-width that holds it, on the compiled kernels up to
    3 and on the run-time kernels (K5r, K1r) at the degree itself from 4
    on, where they step faster than the compiled ones."""
    pad = next(P for P in k1.COMPILED_P + (degree,) if P >= degree)
    _, mg = headline_solve.build(8, degree, solver, device="cpu")
    low = mg.levels_pre if solver == "pcg" else mg.levels32
    plans = [mg._plan_df] + [lev.A.plan for lev in low]
    assert [plan.P for plan in plans] == [max(degree, pad)] * len(plans)
    assert [plan.runtime for plan in plans] == [degree > 3] * len(plans)


@pytest.mark.slow
def test_periodic_degree_8_stalls_as_in_jax():
    """Once, outside tier-1 (about 80 s and 3 GB: both packages assemble
    the banded periodic operator, 4,913 coefficients a point): the periodic
    shifted 3D dw-PCG at degree 8 (34³, 2 levels, the headline cycle) does
    not converge, and the JAX package's history is the port's, entry by
    entry, with its λ: the stall that chip_smoke.py phase 22 logs at 48³ is
    the method's."""
    with jax.disable_jit():
        rp = ref_periodic(3, 34, degree=8, shift=1.0)
        ref = RefPCG(rp, 2, RefCycle(nu1=1, nu2=1, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0)), mixed=True, operator="kron",
            precision="dw")
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=1e-10, maxiter=5)
    prob = periodic_problem(3, 34, degree=8, device="cpu")
    pcg = MGPreconditionedCG(prob, 2, CycleConfig(nu1=1, nu2=1,
                                                  smoother=SmootherConfig(
                                                      "chebyshev",
                                                      cheb_fraction=16.0)),
                             mixed=True, operator="kron", precision="dw")
    pcg.lams = convert.lams(lams)
    pres = pcg.solve(tol=1e-10, maxiter=5)
    assert len(pres.residuals) == len(rres.residuals) == 6
    for a, b in zip(pres.residuals, rres.residuals):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    assert min(pres.residuals[1:]) > pres.residuals[0]


# -- the limits ---------------------------------------------------------------------

def test_degree_9_is_refused_on_the_card_and_runs_plain_on_the_cpu():
    """Degree 9 is no longer refused on the card: its plans are the
    run-time kernels' (K1r, K5r) at half-width 9.  The refusal sits at the
    first half-width whose smallest block of the run-time kernel (one warp
    a pass) takes more shared memory than a block may have (K1r 219 in f32
    and bf16, 109 in f64; K5r 139 with 3 or 4 histories) and names the
    bytes; the CPU's plain versions take any half-width, past that one too
    (a plan with no tiling and no scratch)."""
    cuda = torch.device("cuda")
    for smem, what, widest in ((k1.k1r_smem(4), "K1r", 218),
                               (k1.k1r_smem(8), "K1r", 108),
                               (tf.k5r_smem(3), "K5r", 138),
                               (tf.k5r_smem(4), "K5r", 138)):
        k1.refuse_half_width((9, 9, 9), cuda, smem, what)   # no refusal
        assert k1.widest_half_width(smem) == widest
        k1.refuse_half_width((widest,) * 3, cuda, smem, what)
        with pytest.raises(RuntimeError) as err:
            k1.refuse_half_width((widest + 1,) * 3, cuda, smem, what)
        msg = str(err.value)
        need = smem(widest + 1, *k1.SMALLEST_BLOCK)
        assert need > K2_SMEM
        assert f"{need} bytes" in msg and str(K2_SMEM) in msg, msg
        assert f"degree {widest + 1}" in msg and what in msg, msg
        k1.refuse_half_width((widest + 1,) * 3, torch.device("cpu"), smem,
                             what)
    pp = poisson_problem(2, 12, degree=9, device="cpu", operator="kron")
    assert pp.A.plan.P == 9 and pp.A.plan.runtime
    r = pp.A.residual(StencilVector.from_interior(
        pp.space, torch.zeros(pp.space.npts, dtype=torch.float64)), pp.b)
    assert torch.equal(r, pp.b.interior)
    rng = np.random.default_rng(109)
    band = torch.from_numpy(rng.standard_normal((40, 219)))
    plan = k1.build_kron_plan([[band]], (40,), (109,), (False,))
    assert plan.runtime and plan.P == 109
    assert plan.tiling is None and plan.scratch is None
    b = torch.from_numpy(rng.standard_normal(40))
    assert torch.equal(k1.kron_mode("residual", plan,
                                    torch.zeros(40, dtype=torch.float64), b=b),
                       b)


def test_k2_plan_cuts_runs_for_wide_bands_and_refuses_what_never_fits():
    """3D rows of 256 at p = 7 in f32, and 129-point rows at p = 8 in f64:
    the default runs' x window takes more shared memory than a block may
    have, so the plan cuts each row into shorter runs until the block fits
    (the kernel takes any runs along rows); at p = 20 not even a one-point
    run fits, and the plan refuses, naming the bytes."""
    for npts, p, dtype, m2 in (((8, 8, 256), 7, torch.float32, 2),
                               ((9, 12, 129), 8, torch.float64, 2),
                               ((8, 8, 100), 7, torch.float32, 0)):
        n3, p3, _ = k2_lift(npts, (p,) * 3)
        plan = k2_plan(n3, p3, dtype)
        assert plan["smem"] <= K2_SMEM and plan["m2"] == m2
        if m2:
            assert plan["rl"] == -(-npts[2] // m2)
            assert plan["wj"] == 2 * p + 1 and plan["wc"] == plan["rl"] + 2 * p
            assert plan["runs"] == npts[1] * m2
    assert k2_plan(*k2_lift((513, 513), (8, 8))[:2], torch.float64)["smem"] \
        <= K2_SMEM
    with pytest.raises(RuntimeError, match=str(K2_SMEM)) as err:
        k2_plan((2, 2, 2), (20, 20, 20), torch.float32)
    assert "bytes of shared memory" in str(err.value)


@pytest.mark.parametrize("dtype,first", [(torch.float32, 6),
                                         (torch.float64, 5),
                                         (torch.bfloat16, 8)])
def test_k3_tile_shrinks_for_wide_bands(dtype, first):
    """K3's 3D tile stages 3 slabs of (2p+1)·T0·T1·T2 values and the x
    window: the default tile fits a block up to p = ``first``; wider bands
    take a smaller tile, up to p = 8 in every dtype; at p = 20 none fits
    and the wrapper refuses on the card."""
    default = tile_v2((40, 40, 40), dtype, (0, 0, 0))
    for p in range(1, 9):
        tile = tile_v2((40, 40, 40), dtype, (p,) * 3)
        assert k3_smem_bytes(tile, (p,) * 3, dtype) <= K2_SMEM
        assert (tile == default) == (p <= first), (p, tile)
    wide = tile_v2((40, 40, 40), dtype, (20,) * 3)
    assert k3_smem_bytes(wide, (20,) * 3, dtype) > K2_SMEM
    assert k3_smem_bytes((1, 8, 32), (0, 8, 8), dtype) <= K2_SMEM
