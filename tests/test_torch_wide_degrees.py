"""Spline degrees above 8 (the run-time kernels K1r and K5r) on the CPU
against the JAX package, the run-time tiling and its limits.

Every input is drawn from numpy seeds and goes through the JAX function and
the port's wrapper, which runs its plain version for CPU tensors.  K1's
modes are held to K1's tolerances (f32 1e-6 of max|y|, f64 1e-13: the
summation order is the only difference), the double-word residual within
1e-13 of max|r| (the JAX side may contract a multiply-add).  The launch
data of K1r and K5r (bands at their own half-width, runs of terms) is
executed in plain PyTorch and must give the single pass's values.  The
solver histories are held entry by entry with f64 cycles, and with the f32
cycles of the defect correction: the dw-PCG's f32 cycles at these degrees
scatter by 1e-2 to 7e-1 between two orders of summation (the port against
the JAX package at 8³ degree 9), so its entries are not compared.
"""
import math

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
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import kron as k1
from poms_tpu_torch.ops import twofloat as tf
from poms_tpu_torch.ops.stencil import K2_SMEM

torch.set_num_threads(1)

DEGREES = (9, 10, 12)
TOL = {32: 1e-6, 64: 1e-13}
DT = {32: (jnp.float32, torch.float32), 64: (jnp.float64, torch.float64)}
# the widest half-width of each run-time kernel: its smallest block (one
# warp a pass) within a block's shared memory
WIDEST = {"K1r f32": 218, "K1r f64": 108, "K5r 3": 138, "K5r 4": 138}


def _smem(name):
    kernel, kind = name.split()
    if kernel == "K1r":
        return k1.k1r_smem(4 if kind == "f32" else 8)
    return tf.k5r_smem(int(kind))


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


def _terms(Ks, Ms, S=None):
    """K on axis a, M elsewhere; with ``S``, a first term S M M (the
    periodic shifted operator's shape: 4 histories)."""
    d = len(Ks)
    terms = [[Ks[b] if b == a else Ms[b] for b in range(d)] for a in range(d)]
    return terms if S is None else [[S] + list(Ms[1:])] + terms


def _unfoldable(terms):
    """A 3D operator of ``_terms(Ks, Ms, S)`` with its first term S M M made
    S K K: four terms, three distinct axis-0 bands, no two sharing two axes'
    bands, so K1's plan folds none of them and takes two runs (S M M + K M M
    would fold into (S + K) M M: ``ops/kron.py::fold_terms``)."""
    if len(terms[0]) != 3:
        return terms
    return [[terms[0][0], terms[2][1], terms[3][2]]] + terms[1:]


def _rel(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _split_terms(terms):
    seen = {}
    return [[seen.setdefault(id(B), tf.split_f64(torch.as_tensor(B)))
             for B in term] for term in terms]


# -- K1's modes at degrees 9, 10 and 12 (K1r's plans) ----------------------

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
    assert op.plan.runtime and op.plan.P == degree and op.plan.tcols == 1
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


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("shape", [1, 2])
def test_k1r_plan_executes_the_plain_apply(degree, shape):
    """K1r's launch data (bands at their own half-width, the lifted
    geometry, the sharing plan; a 4-term operator in two runs) executed in
    plain PyTorch gives the plain apply."""
    npts, periodic = _shapes(degree)[shape]
    pads = (degree,) * len(npts)
    Ks, Ms, (x, _, _) = _bands(npts, degree, seed=degree + shape)
    terms = _unfoldable(_terms([torch.as_tensor(K) for K in Ks],
                               [torch.as_tensor(M) for M in Ms],
                               S=torch.as_tensor(Ms[0])
                               if len(npts) == 3 else None))
    plan = k1.build_kron_plan(terms, npts, pads, periodic)
    assert plan.runtime and plan.P == degree
    assert len(plan.plans) == (2 if len(npts) == 3 else 1)
    x = torch.from_numpy(x)
    want = k1.kron_apply_plain(terms, x, npts, pads, periodic)
    assert _rel(k1.plan_apply(plan, x), want.numpy()) <= 1e-13


# -- K5 at degrees 9, 10 and 12 --------------------------------------------

@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("four", [False, True])
def test_residual_kron_df_matches_jax(degree, four):
    """The double-word residual of a Poisson-shaped operator (3 histories)
    and of the periodic shifted shape (4) within 1e-13 of max|r| of the JAX
    one, and near the f64 residual."""
    npts, periodic = _shapes(degree)[2]
    pads = (degree,) * 3
    Ks, Ms, (x, b, _) = _bands(npts, degree, seed=degree + 7 * four)
    S = 0.5 * Ms[0] if four else None
    jterms = _terms([jnp.asarray(K) for K in Ks], [jnp.asarray(M) for M in Ms],
                    None if S is None else jnp.asarray(S))
    tterms = _terms([torch.as_tensor(K) for K in Ks],
                    [torch.as_tensor(M) for M in Ms],
                    None if S is None else torch.as_tensor(S))
    jdf = [[ref_tf.split_f64(B) for B in term] for term in jterms]
    rj = ref_tf.merge_f64(*ref_tf.residual_kron_df(
        jdf, *ref_tf.split_f64(jnp.asarray(b)),
        *ref_tf.split_f64(jnp.asarray(x)), pads))
    tdf = _split_terms(tterms)
    plan = tf.build_kron_df_plan(tdf, npts, pads)
    assert plan.runtime and plan.P == degree
    assert len(k1.sharing_plan(plan.labels)["w_src"]) == (4 if four else 3)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    rt = tf.merge_f64(*tf.residual_kron_df(
        tdf, *tf.split_f64(bt), *tf.split_f64(xt), pads, plan=plan))
    assert _rel(rt, np.asarray(rj)) <= 1e-13
    r64 = bt - k1.kron_apply_plain(tterms, xt, npts, pads, periodic)
    assert _rel(rt, r64.numpy()) <= 1e-12


def _plan_residual_df(plan, bh, bl, xh, xl, negate=False):
    """K5r's launches in plain PyTorch: the plan's stacked bands, lifted
    geometry and runs of terms, each run's terms added onto the sum of the
    runs before it and the last forming b − sum (``negate``: −(b − sum))."""
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


@pytest.mark.parametrize("p,nterms,periodic", [(9, 6, False), (12, 3, True),
                                               (16, 5, False)])
def test_k5r_plan_equals_the_single_pass(p, nterms, periodic):
    """K5r's launch data, executed in plain PyTorch: a Poisson-shaped
    operator in one run (periodic) and sharing-free operators of 5 and 6
    terms in three runs chained through the sum so far give the single
    pass's words bit for bit, also negated."""
    rng = np.random.default_rng(p)
    npts = (p + 3, p + 4, p + 5) if not periodic else (2 * p + 3,) * 3
    if nterms == 3:
        Ks, Ms, _ = _bands(npts, p, seed=p)
        terms = _split_terms(_terms(Ks, Ms))
    else:
        terms = _split_terms([[rng.standard_normal((n, 2 * p + 1))
                               for n in npts] for _ in range(nterms)])
    per = (periodic,) * 3
    plan = tf.build_kron_df_plan(terms, npts, (p,) * 3, per)
    assert plan.runtime and plan.P == p
    assert len(plan.chunks) == (1 if nterms == 3 else 3)
    (xh, xl), (bh, bl) = (tf.split_f64(torch.from_numpy(
        rng.standard_normal(npts))) for _ in range(2))
    for negate in (False, True):
        got = _plan_residual_df(plan, bh, bl, xh, xl, negate)
        want = tf.residual_kron_df_plain(terms, bh, bl, xh, xl, (p,) * 3,
                                         periodic=per, negate=negate)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("p,nterms,periodic", [(9, 3, False), (9, 4, True),
                                               (12, 3, True), (12, 6, False),
                                               (12, 4, False)])
def test_k5r_plain_passes_chained_are_the_single_pass(p, nterms, periodic):
    """K5r's three plain passes (``k5r_pass_plain``), chained per run of
    terms as the card chains them: 3 histories (Poisson), 4 (the periodic
    shifted shape) and 6 sharing-free terms in three runs, periodic or not,
    give ``residual_kron_df_plain``'s words bit for bit, b given and as
    A·p, negated or not."""
    rng = np.random.default_rng(p + nterms)
    npts = (2 * p + 3, 2 * p + 4, 2 * p + 5)
    if nterms == 6:
        terms = _split_terms([[rng.standard_normal((n, 2 * p + 1))
                               for n in npts] for _ in range(nterms)])
    else:
        Ks, Ms, _ = _bands(npts, p, seed=p)
        terms = _split_terms(_terms(Ks, Ms, 0.5 * Ms[0] if nterms == 4
                                    else None))
    per = (periodic,) * 3
    plan = tf.build_kron_df_plan(terms, npts, (p,) * 3, per)
    assert plan.runtime and len(plan.chunks) == (3 if nterms == 6 else 1)
    assert len(k1.sharing_plan(plan.labels, plan.chunks[0])["w_src"]) == \
        {3: 3, 4: 4, 6: 2}[nterms]
    (xh, xl), (bh, bl) = (tf.split_f64(torch.from_numpy(
        rng.standard_normal(npts))) for _ in range(2))
    zero = torch.zeros_like(xh)
    for given, negate in (((bh, bl, xh, xl), False),
                          ((zero, zero, xh, zero), True)):
        got = tf.k5r_passes_plain(plan, *given, negate)
        want = tf.residual_kron_df_plain(terms, *given, (p,) * 3,
                                         periodic=per, negate=negate)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("degree", [9, 12])
@pytest.mark.parametrize("shape", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=["f32", "f64", "bf16"])
def test_k1r_plain_passes_chained_match_kron_mode_plain(degree, shape,
                                                        dtype):
    """K1r's three plain passes (``k1r_pass_plain``), chained per run of
    terms as the card chains them (a 4-term 3D operator in two runs), give
    ``kron_mode_plain`` in every mode and dtype: within 1e-6 of max|y| in
    f32, 1e-13 in f64 (the order of the sums differs), one bf16 unit
    (both round once from f32)."""
    npts, periodic = _shapes(degree)[shape]
    pads = (degree,) * len(npts)
    Ks, Ms, (x, b, d) = _bands(npts, degree, seed=3 * degree + shape)
    cast = {}
    terms = _unfoldable(_terms(
        [cast.setdefault(id(K), torch.as_tensor(K).to(dtype)) for K in Ks],
        [cast.setdefault(id(M), torch.as_tensor(M).to(dtype)) for M in Ms],
        torch.as_tensor(0.5 * Ms[0]).to(dtype) if len(npts) == 3 else None))
    plan = k1.build_kron_plan(terms, npts, pads, periodic)
    assert plan.runtime and len(plan.plans) == (2 if len(npts) == 3 else 1)
    x, b, d = (torch.from_numpy(t).to(dtype) for t in (x, b, d))
    for mode in k1.MODES:
        kw = {"b": b} if mode in ("residual", "cheb") else {}
        if mode == "cheb":
            kw.update(d=d, c1=0.3, c2=0.7)
        got = k1.k1r_passes_plain(mode, plan, x, **kw)
        want = k1.kron_mode(mode, plan, x, **kw)
        if mode != "cheb":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            if dtype == torch.bfloat16:
                ulp = torch.finfo(torch.bfloat16).eps
                assert bool(((g.float() - w.float()).abs()
                             <= ulp * w.float().abs() + 1e-30).all())
            else:
                tol = 1e-6 if dtype == torch.float32 else 1e-13
                assert _rel(g, w.numpy()) <= tol, mode


# -- the run-time tiling and its limits --------------------------------------

@pytest.mark.parametrize("name", sorted(WIDEST))
def test_runtime_tiling_fits_to_the_widest_half_width(name):
    """At the headline's 128³ elements ((126 + P)³ points) every half-width
    from 9 to the kernel's widest gets a launch shape whose every pass's
    block fits a block's shared memory (pass A's tiles at most 64 columns
    wide for K1r, 32 for K5r, even, an even split of axis 2); up to P = 16
    the grid fills the card without the smallest blocks; one past the
    widest no block fits, the card refuses it naming the bytes, and the
    tiling of a grid whose rows take pass A's widest tile raises."""
    smem = _smem(name)
    widest = WIDEST[name]
    assert k1.widest_half_width(smem) == widest
    kernel, kind = name.split()
    for P in range(9, widest + 1):
        n3 = (126 + P,) * 3
        if kernel == "K1r":
            itemsize = 4 if kind == "f32" else 8
            TL, *warps = k1.runtime_tiling(n3, P,
                                           k1.k1r_step_cost(itemsize, P))
            need = [k1.k1r_pass_smem(itemsize, P, p, w, TL)
                    for p, w in zip(k1.RT_PASSES, warps)]
            assert TL % 2 == 0 and TL <= 64 and TL * math.ceil(
                n3[2] / TL) - n3[2] < math.ceil(n3[2] / TL) * 2
        else:
            TL, *warps = k1.runtime_tiling(
                n3, P, tf.k5_step_cost(P, int(kind), runtime=True),
                max_cols=k1.LANES)
            need = [tf.k5r_pass_smem(P, p, w)
                    for p, w in zip(k1.RT_PASSES, warps)]
            assert TL == k1.LANES
        assert all(w in k1.RT_WARPS for w in warps)
        assert max(need) <= K2_SMEM, (P, TL, warps, need)
        if P <= 16:
            assert max(warps) > 1, (P, warps)
    need = smem(widest + 1, *k1.SMALLEST_BLOCK)
    assert need > K2_SMEM >= smem(widest, *k1.SMALLEST_BLOCK)
    with pytest.raises(RuntimeError, match=f"{need} bytes"):
        k1.refuse_half_width((widest + 1,) * 3, torch.device("cuda"), smem,
                             kernel)
    with pytest.raises(ValueError, match="fits a block"):
        k1.runtime_tiling((126 + widest + 1,) * 2 + (64,), widest + 1,
                          tf.k5_step_cost(widest + 1, 4, runtime=True)
                          if kernel == "K5r" else
                          k1.k1r_step_cost(4 if kind == "f32" else 8,
                                           widest + 1),
                          max_cols=k1.LANES if kernel == "K5r" else 64)


@pytest.mark.parametrize("itemsize,words", [(4, 4), (8, 4), (2, 4)])
def test_runtime_scratch_bytes(itemsize, words):
    """A run-time plan's scratch: K1r (kCU + kCG) fields of its arithmetic
    type (bf16 in f32), 42 MB at 138³ in f32; K5r 2 (kCU + kCV) f32 fields,
    105 MB at 138³; the plan's docstrings state them."""
    n = 138 ** 3
    arith = 4 if itemsize == 2 else itemsize
    assert words == k1.CAPS["u"] + k1.CAPS["g"]
    assert round(words * n * arith / 1e6) == {4: 42, 8: 84}[arith]
    assert round(2 * (tf.CAPS_DW["u"] + tf.CAPS_DW["v"]) * n * 4 / 1e6) \
        == 105
    assert "42 MB" in k1.build_kron_plan.__doc__
    assert "105 MB" in tf.build_kron_df_plan.__doc__


def test_compiled_tilings_are_unchanged():
    """The compiled kernels' plans (every compiled half-width, asked for by
    ``half_widths`` above 3) take the tiles of the standard search with
    K1's model; an empty ``half_widths`` gives K1r's plan at any P, one
    column a thread."""
    for P in k1.INSTANTIATED_P:
        plan = k1.build_kron_plan([[torch.zeros(n, 2 * P + 1)
                                    for n in (129,) * 3]], (129,) * 3,
                                  (P,) * 3, (False,) * 3,
                                  half_widths=k1.INSTANTIATED_P)
        assert not plan.runtime and (plan.trows, plan.tiling) == (
            k1.k1_tiling((129,) * 3, P, 4))
    runtime = k1.build_kron_plan([[torch.zeros(129, 7)] * 3], (129,) * 3,
                                 (3,) * 3, (False,) * 3, half_widths=())
    assert runtime.runtime and runtime.P == 3 and runtime.tcols == 1


def test_headline_example_builds_degrees_9_and_12_on_their_half_widths():
    """The headline example's solvers at degrees 9 and 12: K5r's plan and
    every cycle level's K1r plan at the degree itself."""
    for solver, degree in (("pcg", 9), ("dc", 12)):
        _, mg = headline_solve.build(16, degree, solver, device="cpu")
        low = mg.levels_pre if solver == "pcg" else mg.levels32
        assert mg._plan_df.runtime and mg._plan_df.P == degree
        assert all(lev.A.plan.runtime and lev.A.plan.P == degree
                   for lev in low)


# -- the solvers at degrees 9 and 10 -----------------------------------------

# (kind, dim, n_el, degree): the f64-cycle PCG (no f32 rounding in the way)
# and the twofloat defect correction (f32 cycles), 8 entries each
SOLVES = [("f64", 3, 8, 9), ("f64", 2, 16, 10), ("dc", 2, 16, 10)]


@pytest.mark.parametrize("kind,dim,n_el,degree", SOLVES)
def test_solver_histories_match_jax(kind, dim, n_el, degree):
    """The first 8 entries of the history, the reference's (eagerly: XLA:CPU
    compiles the double-word graphs for minutes) and the port's with its λ
    estimates, within 1e-3 of each other.  At these sizes 7 iterations stay
    far above 1e-10."""
    with jax.disable_jit():
        rp = ref_problem(dim, n_el, degree=degree, operator="kron")
        cfg = RefCycle(nu1=1, nu2=1, smoother=RefSmoother(
            "chebyshev", cheb_fraction=16.0))
        if kind == "f64":
            ref = RefPCG(rp, 2, cfg, mixed=False, operator="kron")
            lams = ref_lams(ref.levels, ref.cfg.smoother)
        else:
            ref = RefMG(rp, 2, cfg, operator="kron", residual="twofloat")
            lams = ref_lams(ref.levels64, ref.cfg.smoother)
        rres = ref.solve(tol=1e-30, maxiter=7)
    pp = poisson_problem(dim, n_el, degree=degree, device="cpu",
                         operator="kron")
    pcfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    if kind == "f64":
        port = MGPreconditionedCG(pp, 2, pcfg, mixed=False, operator="kron")
    else:
        port = MixedPrecisionMG(pp, 2, pcfg, operator="kron",
                                residual="twofloat")
        assert port._plan_df.runtime and port._plan_df.P == degree
    levels = port.levels32 if kind == "dc" else port.levels
    assert all(lev.A.plan.runtime for lev in levels)
    port.lams = convert.lams(lams)
    pres = port.solve(tol=1e-30, maxiter=7)
    assert len(pres.residuals) == len(rres.residuals) == 8
    for a, b in zip(pres.residuals, rres.residuals):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    assert pres.residuals[-1] > 1e-10
