"""bf16 cycles on the CPU: the port's bf16 plain versions and solvers against
the JAX package's.

bf16 arithmetic is not bitwise across XLA and PyTorch, and the port's bf16
kernels do not even compute what the reference computes: they read and write
bf16 and compute in f32 (one rounding per output value), where the
reference's kernels and XLA expressions round to bf16 after every operation.
So a kernel's two versions are each held to an f64 evaluation of the same
bf16-rounded inputs, with S the sum of the magnitudes that enter an output
value (Σ|band·x|, plus |b|, |x| where the mode reads them):

- the port within 2⁻⁸·S (one rounding of a value of at most S is 2⁻⁹·S; the
  f32 sum under it adds about 1e-6·S);
- the reference within K·2⁻⁸·S, K the number of terms it adds and rounds
  (the (2p+1)^d band offsets for K2/K3; the taps of every axis pass for K1
  and K7).

Solvers are held to iteration counts and final residuals, with the
reference's λ estimates passed in, never to histories.
"""
import contextlib
import functools
import itertools

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
from poms_tpu.models.bspline import prolongation_interior_1d
from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu.ops import transfer as ref_transfer
from poms_tpu.ops.pallas import spmv as ref_pallas
from poms_tpu_torch import convert
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops import kron as kron_ops
from poms_tpu_torch.ops import transfer
from poms_tpu_torch.ops.stencil import stencil_apply, stencil_apply_plain
from poms_tpu_torch.ops.stencil_v2 import pack_band_v2, stencil_apply_v2

torch.set_num_threads(1)

BF16 = torch.bfloat16
EPS = 2.0 ** -8
TOL = 1e-10


def _bf16(a) -> torch.Tensor:
    """A numpy array rounded to bf16 (both packages get these values)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(t.astype(jnp.float32), np.float64)


# -- (a) K2 and K3 -----------------------------------------------------------

STENCIL_CASES = [((6, 7, 20), 1), ((16, 24), 2), ((600,), 2)]
OMEGA = 0.8


def _stencil_operands(npts, p, seed):
    d = len(npts)
    rng = np.random.default_rng(seed)
    terms = (2 * p + 1) ** d
    band = rng.standard_normal((2 * p + 1,) * d + npts) / (2 * np.sqrt(terms))
    band[(p,) * d] += 5.0
    return (_bf16(band), _bf16(rng.standard_normal(
        tuple(n + 2 * p for n in npts))), _bf16(rng.standard_normal(npts)))


def _stencil_exact(mode, band, x_pad, b, npts, p, color):
    """(f64 value, S) of one mode from the bf16-rounded operands."""
    d = len(npts)
    B, X, bb = _f64(band), _f64(x_pad), _f64(b)
    ax = np.zeros(npts)
    mag = np.zeros(npts)
    for k in itertools.product(range(2 * p + 1), repeat=d):
        sh = X[tuple(slice(ki, ki + n) for ki, n in zip(k, npts))]
        ax += B[k] * sh
        mag += np.abs(B[k] * sh)
    if mode == "spmv":
        return ax, mag
    if mode == "residual":
        return bb - ax, mag + np.abs(bb)
    diag = B[(p,) * d]
    xi = X[tuple(slice(p, p + n) for n in npts)]
    scale = np.abs(xi) + OMEGA * (np.abs(bb) + mag) / np.abs(diag)
    if mode == "jacobi":
        return xi + OMEGA * (bb - ax) / diag, scale
    idx = sum(np.meshgrid(*[np.arange(n) for n in npts], indexing="ij"))
    gs = (1 - OMEGA) * xi + OMEGA * (bb - (ax - diag * xi)) / diag
    return np.where(idx % 2 == color, gs, xi), scale


def _ref_stencil(mode, band, x_pad, b, npts, p, color):
    args = (_jnp(band), _jnp(x_pad))
    pads = (p,) * len(npts)
    if mode == "spmv":
        return ref_pallas.spmv_banded_pallas(*args, npts, pads, interpret=True)
    if mode == "residual":
        return ref_pallas.residual_fused_pallas(*args, _jnp(b), npts, pads,
                                                interpret=True)
    if mode == "jacobi":
        return ref_pallas.jacobi_fused_pallas(*args, _jnp(b), OMEGA, npts,
                                              pads, interpret=True)
    return ref_pallas.rbgs_color_pallas(*args, _jnp(b), OMEGA, color, npts,
                                        pads, interpret=True)


@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("mode", ["spmv", "residual", "jacobi", "rbgs"])
@pytest.mark.parametrize("npts,p", STENCIL_CASES)
def test_banded_bf16_port_and_jax_against_f64(monkeypatch, engine, mode,
                                              npts, p):
    """K2's (v1) and K3's (v2) plain versions and the JAX Pallas engines in
    interpret mode, each against the f64 value: the port within 2⁻⁸·S, the
    reference within (2p+1)^d·2⁻⁸·S."""
    monkeypatch.setenv("POMS_TPU_SPMV", engine)
    band, x_pad, b = _stencil_operands(npts, p, seed=len(npts) + p)
    color = 1
    pads = (p,) * len(npts)
    kw = dict(b=None if mode == "spmv" else b,
              omega=OMEGA if mode in ("jacobi", "rbgs") else None,
              color=color)
    if engine == "v2":
        packed = pack_band_v2(band, npts, pads)
        assert packed["blk"].dtype == BF16 and packed["N"][2] % 8 == 0
        got = stencil_apply_v2(mode, None, x_pad, npts, pads, packed=packed,
                               **kw)
    else:
        got = stencil_apply(mode, band, x_pad, npts, pads, **kw)
    assert got.dtype == BF16
    exact, S = _stencil_exact(mode, band, x_pad, b, npts, p, color)
    assert (np.abs(_f64(got) - exact) <= EPS * S).all()
    want = _ref_stencil(mode, band, x_pad, b, npts, p, color)
    assert want.dtype == jnp.bfloat16
    K = (2 * p + 1) ** len(npts)
    assert (np.abs(_f64(want) - exact) <= K * EPS * S).all()
    # and the two against each other, by the sum of the two bounds
    assert (np.abs(_f64(got) - _f64(want)) <= (K + 1) * EPS * S).all()


def test_bf16_plain_version_rounds_once():
    """The bf16 plain version is the f32 one on the cast operands, rounded:
    what the kernel computes."""
    band, x_pad, b = _stencil_operands((6, 7, 20), 1, seed=9)
    f32 = torch.float32
    for mode in ("spmv", "residual", "jacobi", "rbgs"):
        kw = dict(b=None if mode == "spmv" else b, omega=0.7)
        kw32 = dict(b=None if mode == "spmv" else b.to(f32), omega=0.7)
        got = stencil_apply_plain(mode, band, x_pad, (6, 7, 20), (1, 1, 1),
                                  **kw)
        want = stencil_apply_plain(mode, band.to(f32), x_pad.to(f32),
                                   (6, 7, 20), (1, 1, 1), **kw32).to(BF16)
        assert torch.equal(got, want)


# -- (b) K1 and K7 -----------------------------------------------------------

KRON_CASES = [((40,), (3,), (False,)), ((12, 18), (2, 2), (True, False)),
              ((6, 8, 10), (2, 1, 2), (False, False, True))]


def _kron_pair(npts, pads, periodic, seed):
    """A Poisson-shaped bf16 operator (K on axis a, M elsewhere) in both
    packages, from the same rounded bands, and three rounded fields."""
    rng = np.random.default_rng(seed)
    d = len(npts)

    def band(n, p):
        return _bf16(rng.standard_normal((n, 2 * p + 1)) / 4
                     + 2.0 * (np.arange(2 * p + 1) == p))

    Ks = [band(n, p) for n, p in zip(npts, pads)]
    Ms = [band(n, p) for n, p in zip(npts, pads)]
    terms = [[Ks[b] if b == a else Ms[b] for b in range(d)] for a in range(d)]
    cast = {id(B): _jnp(B) for B in Ks + Ms}
    rterms = [[cast[id(B)] for B in term] for term in terms]
    port = KroneckerSumOperator(
        StencilVectorSpace(npts=npts, pads=pads, periodic=periodic,
                           dtype=BF16, device="cpu"), terms)
    ref = RefKron(RefSpace(npts=npts, pads=pads, periodic=periodic,
                           dtype=jnp.bfloat16), rterms)
    fields = [_bf16(rng.standard_normal(npts)) for _ in range(3)]
    return port, ref, terms, fields


def _kron_exact(terms, x, npts, pads, periodic):
    """(A x, Σ|terms|) in f64 from the rounded bands: |A|·|x| bounds every
    partial sum of every axis pass."""
    hi = [[B.to(torch.float64) for B in term] for term in terms]
    ab = [[B.abs() for B in term] for term in hi]
    x64 = x.to(torch.float64)
    return (kron_ops.kron_apply_plain(hi, x64, npts, pads, periodic).numpy(),
            kron_ops.kron_apply_plain(ab, x64.abs(), npts, pads,
                                      periodic).numpy())


@pytest.mark.parametrize("npts,pads,periodic", KRON_CASES)
def test_kron_bf16_modes_port_and_jax_against_f64(npts, pads, periodic):
    """K1's four modes in bf16 (the plain version the kernel is held to)
    and the reference's bf16 ``dot`` with the elementwise expressions around
    it, each against f64: 2⁻⁸·S and K·2⁻⁸·S, K = Σ_a (2p_a+1) taps per term
    times the terms, plus the epilogue's operations."""
    port, ref, terms, (x, b, dvec) = _kron_pair(npts, pads, periodic, seed=4)
    ax, mag = _kron_exact(terms, x, npts, pads, periodic)
    K = len(terms) * sum(2 * p + 1 for p in pads) + 6
    diag64 = port.plan.operands_f32()[1].to(torch.float64).numpy()
    x64, b64, d64 = _f64(x), _f64(b), _f64(dvec)
    c1, c2 = 0.3, 0.7
    rax = ref.dot(RefVec.from_interior(ref.space, _jnp(x))).interior
    rdiag = ref.diagonal()
    assert rax.dtype == jnp.bfloat16

    def check(got, want, exact, S):
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert (np.abs(_f64(got) - exact) <= EPS * S).all()
        assert (np.abs(_f64(want) - exact) <= K * EPS * S).all()

    check(port._apply_interior(x), rax, ax, mag)
    check(port.residual(port_vec(port, x), port_vec(port, b)),
          _jnp(b) - rax, b64 - ax, mag + np.abs(b64))
    check(port.dinv_apply(x), rax / rdiag, ax / diag64, mag / np.abs(diag64))
    z = (b64 - ax) / diag64
    zS = (np.abs(b64) + mag) / np.abs(diag64)
    rz = (_jnp(b) - rax) / rdiag
    d_new = c1 * d64 + c2 * z
    dS = c1 * np.abs(d64) + c2 * zS
    x_new, d_got = port.cheb_update(x, b, dvec, c1, c2)
    rd = c1 * _jnp(dvec) + c2 * rz
    check(d_got, rd, d_new, dS)
    check(x_new, _jnp(x) + rd, x64 + d_new, np.abs(x64) + dS)
    # the first Chebyshev step has no direction yet
    x0, d0 = port.cheb_update(x, b, None, 0.0, c2)
    assert (np.abs(_f64(d0) - c2 * z) <= EPS * c2 * zS).all()
    assert (np.abs(_f64(x0) - (x64 + c2 * z))
            <= EPS * (np.abs(x64) + c2 * zS)).all()


def port_vec(op, interior):
    from poms_tpu_torch.core.vector import StencilVector

    return StencilVector.from_interior(op.space, interior)


def test_kron_bf16_plan_is_the_f32_kernels():
    """A bf16 operator is computed in f32: two columns a thread and the f32
    cost model, the diagonal by the kernel's rule from the cast columns."""
    port, _, terms, _ = _kron_pair((33, 33, 33), (3, 3, 3), (False,) * 3, 1)
    hi = [[B.to(torch.float32) for B in term] for term in terms]
    plan32 = kron_ops.build_kron_plan(hi, (33,) * 3, (3,) * 3, (False,) * 3)
    assert port.plan.tcols == plan32.tcols == 2
    assert port.plan.tiling == plan32.tiling
    assert port.plan.dtype == BF16 and port.plan.bands[0].dtype == BF16
    assert torch.equal(port.plan.operands_f32()[1], plan32.diagonal())
    assert kron_ops.arithmetic_itemsize(BF16) == 4
    assert kron_ops.arithmetic_itemsize(torch.float64) == 8


@pytest.mark.parametrize("n_el,d", [(16, 1), (8, 2), (8, 3)])
def test_transfer_bf16_port_and_jax_against_f64(n_el, d):
    """K7's plain version in bf16 (each axis in f32, rounded once; the add
    inside the last) and the reference's ``apply_transfer_axis`` chain in
    bf16, against f64 on the rounded weights: per axis 2⁻⁸·S and
    W·2⁻⁸·S; over d axes the bounds add, each carried by ‖P‖-weighted
    magnitudes, so the whole is held to d·2⁻⁸·S_d and d·(W+1)·2⁻⁸·S_d with
    S_d = |P|···|P||x| (+ |add|)."""
    p = 3
    P = prolongation_interior_1d(n_el // 2, p)
    rng = np.random.default_rng(n_el + d)
    nf, nc = P.shape
    for M, n_in in ((P, nc), (P.T, nf)):
        tb64 = transfer.bands_from_dense(M, torch.float64, "cpu")
        tb = transfer.TransferBand(w=tb64.w.to(BF16), c0=tb64.c0,
                                   n_in=tb64.n_in)
        rtb = ref_transfer.TransferBand(w=_jnp(tb.w),
                                        c0=jnp.asarray(tb.c0.numpy()),
                                        n_in=tb.n_in)
        x = _bf16(rng.standard_normal((n_in,) * d))
        add = _bf16(rng.standard_normal((tb.n_out,) * d))
        exact = transfer.apply_transfer_plain(
            (transfer.TransferBand(w=tb.w.to(torch.float64), c0=tb.c0,
                                   n_in=tb.n_in),) * d, x.to(torch.float64))
        S = transfer.apply_transfer_plain(
            (transfer.TransferBand(w=tb.w.to(torch.float64).abs(), c0=tb.c0,
                                   n_in=tb.n_in),) * d,
            x.to(torch.float64).abs())
        got = transfer.apply_transfer((tb,) * d, x)
        assert got.dtype == BF16
        assert (np.abs(_f64(got) - exact.numpy())
                <= d * EPS * S.numpy()).all()
        want = _jnp(x)
        for a in range(d):
            want = ref_transfer.apply_transfer_axis(rtb, want, a)
        assert want.dtype == jnp.bfloat16
        W = tb.width
        assert (np.abs(_f64(want) - exact.numpy())
                <= d * (W + 1) * EPS * S.numpy()).all()
        got = transfer.apply_transfer((tb,) * d, x, add=add)
        assert (np.abs(_f64(got) - (exact + add.to(torch.float64)).numpy())
                <= d * EPS * (S + add.to(torch.float64).abs()).numpy()).all()


# -- (c), (d) the solvers ----------------------------------------------------

# (solver, dim, n_el, degree): the reference's f32 → bf16 counts are
# 7 → 9, 7 → 10, 6 → 10 (twofloat), 7 → 11, 6 → 10 (banded f64), 6 → 8 (dw)
SOLVER_CASES = [("twofloat", 1, 64, 3), ("twofloat", 2, 32, 3),
                ("twofloat", 3, 16, 2), ("banded", 2, 32, 3),
                ("banded", 3, 16, 2), ("dw", 2, 32, 3)]


def _make(kind, classes, problem, cycle, smoother, low):
    MG, PCG = classes
    cfg = cycle(nu1=1, nu2=1, smoother=smoother("chebyshev",
                                                cheb_fraction=16.0))
    if kind == "twofloat":
        return MG(problem("kron"), 2, cfg, low_dtype=low,
                  operator="kron", residual="twofloat")
    if kind == "banded":
        return MG(problem("banded"), 2, cfg, low_dtype=low,
                  operator="banded", residual="f64")
    return PCG(problem("kron"), 2, cfg, low_dtype=low,
               operator="kron", precision="dw" if kind == "dw" else "dwrr")


@pytest.fixture(params=SOLVER_CASES,
                ids=lambda c: f"{c[0]}-{c[1]}d-n{c[2]}-p{c[3]}")
def solved(request):
    return _solved(*request.param)


@functools.lru_cache(maxsize=None)
def _solved(kind, dim, n_el, degree):
    """One case solved by the reference (bf16) and by the port (f32 and
    bf16), once per process for both tests."""
    # the double-word graphs take XLA:CPU minutes to compile: run them eagerly
    ctx = jax.disable_jit() if kind != "banded" else contextlib.nullcontext()
    with ctx:
        ref = _make(kind, (RefMG, RefPCG),
                    lambda op: ref_problem(dim, n_el, degree=degree,
                                           operator=op),
                    RefCycle, RefSmoother, jnp.bfloat16)
        levels = ref.levels64 if hasattr(ref, "levels64") else ref.levels
        lams = ref_lams(levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=60)
    out = {}
    for low in (torch.float32, BF16):
        port = _make(kind, (MixedPrecisionMG, MGPreconditionedCG),
                     lambda op: poisson_problem(dim, n_el, degree=degree,
                                                operator=op, device="cpu"),
                     CycleConfig, SmootherConfig, low)
        port.lams = convert.lams(lams)
        out[low] = (port, port.solve(tol=TOL, maxiter=60))
    return kind, rres, out


def test_bf16_solvers_converge_within_the_count_bounds(solved):
    """Converged to 1e-10 with a true f64 residual ≤ 5e-10; the port's bf16
    count is at most the reference's bf16 count + 2 and at most twice its
    own f32 count."""
    kind, rres, out = solved
    assert rres.converged
    (_, res32), (port, res) = out[torch.float32], out[BF16]
    assert res32.converged and res.converged, (res32.residuals[-1],
                                               res.residuals[-1])
    assert res.residuals[-1] <= TOL
    prob = port.problem
    r = prob.b.interior - prob.A.dot(res.x).interior
    assert r.dtype == torch.float64
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
    assert res.iterations <= rres.iterations + 2, (res.iterations,
                                                   rres.iterations)
    assert res.iterations <= 2 * res32.iterations, (res.iterations,
                                                    res32.iterations)
    low = port.levels32 if kind != "dw" else port.levels_pre
    assert all(lev.A.space.dtype == BF16 for lev in low)
    assert low[-1].chol.L.dtype == torch.float32     # the coarse factor


def test_bf16_solve_compiled_equals_solve(solved):
    _, _, out = solved
    port, res = out[BF16]
    x, rn, it = port.solve_compiled(tol=TOL, maxiter=60)
    assert it == res.iterations and float(rn) == res.residuals[-1]
    assert torch.equal(x.interior, res.x.interior)


def test_bf16_dwrr_count_matches_jax():
    """Residual-replacement PCG over a bf16 hierarchy at 16³ p2: its A·p
    goes through the bf16 operator (p rounded to bf16 here, promoted to f32
    in the reference), so the counts are compared, not the histories."""
    with jax.disable_jit():
        ref = _make("dwrr", (RefMG, RefPCG),
                    lambda op: ref_problem(3, 16, degree=2, operator=op),
                    RefCycle, RefSmoother, jnp.bfloat16)
        lams = ref_lams(ref.levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=90)
    port = _make("dwrr", (MixedPrecisionMG, MGPreconditionedCG),
                 lambda op: poisson_problem(3, 16, degree=2, operator=op,
                                            device="cpu"),
                 CycleConfig, SmootherConfig, BF16)
    port.lams = convert.lams(lams)
    res = port.solve(tol=TOL, maxiter=90)
    assert rres.converged and res.converged
    assert res.iterations % port.replace_every == 0
    assert abs(res.iterations - rres.iterations) <= port.replace_every, \
        (res.iterations, rres.iterations)
    prob = port.problem
    r = prob.b.interior - prob.A.dot(res.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
    x, rn, it = port.solve_compiled(tol=TOL, maxiter=90)
    assert it == res.iterations and float(rn) == res.residuals[-1]
    assert torch.equal(x.interior, res.x.interior)


def test_bf16_hierarchy_carried_across():
    """convert.levels on the reference's bf16 hierarchy: bf16 bands and
    weights with the reference's values, the coarse factor cast up to f32."""
    rp = ref_problem(2, 16, degree=2, operator="kron")
    ref = RefMG(rp, 2, RefCycle(smoother=RefSmoother("jacobi", 0.8)),
                low_dtype=jnp.bfloat16, operator="kron", residual="f64")
    levs = convert.levels(ref.levels32)
    for lev, rlev in zip(levs, ref.levels32):
        assert lev.A.space.dtype == BF16
        for term, rterm in zip(lev.A.terms, rlev.A.terms):
            for B, rB in zip(term, rterm):
                assert B.dtype == BF16
                np.testing.assert_array_equal(_f64(B), _f64(rB))
    assert levs[0].prolong[0].w.dtype == BF16
    np.testing.assert_array_equal(_f64(levs[0].prolong[0].w),
                                  _f64(ref.levels32[0].prolong[0].w))
    assert levs[-1].chol.L.dtype == torch.float32
    np.testing.assert_array_equal(_f64(levs[-1].chol.L),
                                  _f64(ref.levels32[-1].chol.L))
    conv = convert.mixed_precision_mg(ref, ref_lams(ref.levels64,
                                                    ref.cfg.smoother))
    assert conv.low_dtype == BF16
    assert conv.solve(tol=TOL, maxiter=60).converged


def test_bf16_options_and_refusals():
    pp = poisson_problem(1, 16, degree=2, device="cpu", operator="kron")
    with pytest.raises(ValueError, match="low_dtype"):
        MixedPrecisionMG(pp, 2, operator="kron", low_dtype=torch.float16)
    # residual replacement takes a bf16 hierarchy as the reference does
    rr = MGPreconditionedCG(pp, 2, operator="kron", precision="dwrr",
                            low_dtype=BF16)
    assert rr.levels_pre[0].A.space.dtype == BF16
    assert rr.solve(tol=TOL, maxiter=90).converged
    # a pack made for f32 handed to a bf16 apply is refused, on the CPU too
    band, x_pad, _ = _stencil_operands((16, 24), 2, seed=0)
    pk32 = pack_band_v2(band.to(torch.float32), (16, 24), (2, 2))
    with pytest.raises(ValueError, match="pack"):
        stencil_apply_v2("spmv", None, x_pad, (16, 24), (2, 2), packed=pk32)
