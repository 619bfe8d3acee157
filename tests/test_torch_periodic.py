"""Periodic problems: the port's ``models/periodic.py`` and its solvers on a
``PeriodicProblem`` against the JAX package's, on the CPU.

The four tests of ``tests/test_periodic.py`` mirrored on the port; the host
parts (1D bands, coarse triple products, the right-hand side) bitwise against
the reference; the solves with the reference's λ estimates passed in.  The
reference's double-word graphs run eagerly (``jax.disable_jit``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.mg.cycles import CycleConfig as RefCycle
from poms_tpu.mg.cycles import cycle as ref_cycle
from poms_tpu.mg.mixed import MGPreconditionedCG as RefPCG
from poms_tpu.mg.mixed import MixedPrecisionMG as RefMG
from poms_tpu.mg.smoother import SmootherConfig as RefSmoother
from poms_tpu.mg.smoother import attach_spectral_estimates as ref_lams
from poms_tpu.models import periodic as ref_periodic
from poms_tpu.ops.twofloat import residual_kron_df as ref_residual_df
from poms_tpu_torch import convert
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig, cycle
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.bspline import (assemble_periodic_1d,
                                           prolongation_periodic_1d)
from poms_tpu_torch.models.periodic import (_coarse_bands_periodic,
                                            build_periodic_hierarchy,
                                            periodic_problem)
from poms_tpu_torch.ops import twofloat
from poms_tpu_torch.ops.kron import sharing_plan

torch.set_num_threads(1)

TOL = 1e-10


def _cfg(cls=CycleConfig, sm=SmootherConfig):
    return cls(nu1=1, nu2=1, smoother=sm("chebyshev", cheb_fraction=16.0))


def test_periodic_operator_properties():
    prob = periodic_problem(2, 16, degree=2, shift=1.0, device="cpu")
    A = prob.A.toarray()
    np.testing.assert_allclose(A, A.T, atol=1e-12)
    assert np.linalg.eigvalsh(A).min() > 0  # SPD thanks to the shift
    # translation invariance: circulant in each dim (compare two rows)
    n = prob.space.npts
    A4 = A.reshape(n + n)
    np.testing.assert_allclose(A4[3, 4], np.roll(np.roll(A4[4, 5], -1, 0),
                                                 -1, 1), atol=1e-12)
    np.testing.assert_array_equal(
        A, ref_periodic.periodic_problem(2, 16, degree=2).A.toarray())


def test_periodic_prolongation_two_scale():
    """The periodic two-scale P reproduces coarse periodic splines exactly:
    the circulant mass identity M_c = Pᵀ M_f P."""
    p = 3
    Kc, Mc = assemble_periodic_1d(8, p)
    Kf, Mf = assemble_periodic_1d(16, p)

    def dense(Bb):
        n = Bb.shape[0]
        D = np.zeros((n, n))
        for off in range(2 * p + 1):
            cols = (np.arange(n) + off - p) % n
            D[np.arange(n), cols] += Bb[:, off]
        return D

    P = prolongation_periodic_1d(8, p)
    np.testing.assert_allclose(P.T @ dense(Mf) @ P, dense(Mc), atol=1e-12)
    np.testing.assert_allclose(P.T @ dense(Kf) @ P, dense(Kc), atol=1e-10)


@pytest.mark.parametrize("dim,n_el,p,seed", [(1, 64, 2, 0), (2, 32, 3, 5),
                                             (3, 16, 2, 1)])
def test_host_parts_are_bitwise(dim, n_el, p, seed):
    """b, the 1D bands, the band (a single product per entry in 1D and 2D;
    two in 3D, whose order an einsum may choose: 1 ulp there) and every
    level's coarse 1D bands, transfers and operator terms."""
    rp = ref_periodic.periodic_problem(dim, n_el, degree=p, shift=0.5,
                                       seed=seed)
    pp = periodic_problem(dim, n_el, degree=p, shift=0.5, seed=seed,
                          device="cpu")
    assert pp.space.periodic == (True,) * dim and pp.shift == 0.5
    np.testing.assert_array_equal(pp.b.interior.numpy(),
                                  np.asarray(rp.b.interior))
    for (K, M), (rK, rM) in zip(pp.bands_1d, rp.bands_1d):
        np.testing.assert_array_equal(K, rK)
        np.testing.assert_array_equal(M, rM)
    want = np.asarray(rp.A.band_t)
    assert want.dtype == np.float64
    if dim < 3:
        np.testing.assert_array_equal(pp.A.band_t.numpy(), want)
    else:
        np.testing.assert_allclose(pp.A.band_t.numpy(), want, rtol=4.5e-16,
                                   atol=0)
    P1s = [prolongation_periodic_1d(n_el // 2, p)] * dim
    for (K, M), (rK, rM) in zip(
            _coarse_bands_periodic(pp.bands_1d, P1s),
            ref_periodic._coarse_bands_periodic(rp.bands_1d, P1s)):
        np.testing.assert_array_equal(K, rK)
        np.testing.assert_array_equal(M, rM)
    for op in ("kron", "banded"):
        levels = build_periodic_hierarchy(pp, 2, operator=op)
        rlevels = ref_periodic.build_periodic_hierarchy(rp, 2, operator=op)
        for lev, rlev in zip(levels, rlevels):
            if op == "kron":
                for term, rterm in zip(lev.A.terms, rlev.A.terms):
                    for B, rB in zip(term, rterm):
                        np.testing.assert_array_equal(B.numpy(),
                                                      np.asarray(rB))
            for tbs, rtbs in ((lev.prolong, rlev.prolong),
                              (lev.restrict, rlev.restrict)):
                for tb, rtb in zip(tbs or (), rtbs or ()):
                    np.testing.assert_array_equal(tb.w.numpy(),
                                                  np.asarray(rtb.w))
                    np.testing.assert_array_equal(tb.c0.numpy(),
                                                  np.asarray(rtb.c0))
        # the wrapped rows make the banded form as wide as the coarse axis
        assert levels[0].prolong[0].width == n_el // 2
        np.testing.assert_allclose(levels[-1].chol.L.numpy(),
                                   np.asarray(rlevels[-1].chol.L),
                                   rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="coarsen"):
        build_periodic_hierarchy(pp, 6)
    # a hierarchy and a problem carried across are the reference's
    conv = convert.levels(rlevels)
    np.testing.assert_array_equal(conv[0].A.band_t.numpy(), want)
    assert conv[0].A.space.periodic == (True,) * dim
    carried = convert.problem(rp)
    assert carried.shift == 0.5 and carried.n_el == pp.n_el
    np.testing.assert_array_equal(carried.b.interior.numpy(),
                                  np.asarray(rp.b.interior))


@pytest.mark.parametrize("dim,n_el,p", [(1, 64, 2), (2, 32, 3)])
def test_periodic_mg_solve(dim, n_el, p):
    """tests/test_periodic.py::test_periodic_mg_solve on both packages: the
    same cycle count, the history to 1e-3 through entry 5 (5e-3 after), the
    solution against scipy's direct solve; MultigridSolver takes the
    problem."""
    rp = ref_periodic.periodic_problem(dim, n_el, degree=p, shift=1.0)
    rlevels = ref_periodic.build_periodic_hierarchy(rp, num_levels=2)
    rcfg = _cfg(RefCycle, RefSmoother)
    lams = ref_lams(rlevels, rcfg.smoother)
    x = RefVec.zeros(rp.space)
    want = [float((rp.b - rp.A.dot(x)).norm())]
    for _ in range(30):
        x = ref_cycle(rlevels, 0, x, rp.b, rcfg, lams)
        want.append(float((rp.b - rp.A.dot(x)).norm()))
        if want[-1] < TOL:
            break
    pp = periodic_problem(dim, n_el, degree=p, shift=1.0, device="cpu")
    levels = build_periodic_hierarchy(pp, num_levels=2)
    cfg, plams = _cfg(), convert.lams(lams)
    x = StencilVector.zeros(pp.space)
    res = [float((pp.b - pp.A.dot(x)).norm())]
    for _ in range(30):
        x = cycle(levels, 0, x, pp.b, cfg, plams)
        res.append(float((pp.b - pp.A.dot(x)).norm()))
        if res[-1] < TOL:
            break
    assert res[-1] < TOL and len(res) == len(want), (res, want)
    for i, (a, b) in enumerate(zip(res, want)):
        assert abs(a - b) <= (1e-3 if i <= 5 else 5e-3) * b, (i, a, b)
    u_ref = spla.spsolve(pp.A.tocsr(), pp.b.toarray())
    np.testing.assert_allclose(x.toarray(), u_ref, rtol=1e-7, atol=1e-9)
    mg = MultigridSolver(pp, 2, cfg)
    mg.lams = plams
    out = mg.solve(tol=TOL, maxiter=30)
    assert out.converged and out.iterations == len(want) - 1
    with pytest.raises(NotImplementedError):    # as in the JAX package
        MultigridSolver(pp, 2, CycleConfig(
            smoother=SmootherConfig("gs_lex"))).solve(maxiter=1)


def test_periodic_mixed_twofloat_reaches_1e10():
    """tests/test_periodic.py::test_periodic_mixed_twofloat_reaches_1e10 on
    both packages (2D 32 p3, kron, twofloat): the same count, the history
    to 1e-3 through entry 5 and 5e-3 after, the true residual ≤ 5e-10; the
    graph-free ``solve_compiled`` runs the same corrections."""
    with jax.disable_jit():
        rp = ref_periodic.periodic_problem(2, 32, degree=3, shift=1.0)
        ref = RefMG(rp, 2, _cfg(RefCycle, RefSmoother), operator="kron",
                    residual="twofloat")
        lams = ref_lams(ref.levels64, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=60)
    pp = periodic_problem(2, 32, degree=3, shift=1.0, device="cpu")
    mg = MixedPrecisionMG(pp, 2, _cfg(), operator="kron", residual="twofloat")
    mg.lams = convert.lams(lams)
    res = mg.solve(tol=TOL, maxiter=60)
    assert res.converged and rres.converged
    assert res.iterations == rres.iterations, (res.iterations,
                                               rres.iterations)
    for i, (a, b) in enumerate(zip(res.residuals, rres.residuals)):
        assert abs(a - b) <= (1e-3 if i <= 5 else 5e-3) * b, (i, a, b)
    r = pp.b.interior - pp.A.dot(res.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10
    x, rn, it = mg.solve_compiled(tol=TOL, maxiter=60)
    assert it == res.iterations and torch.equal(x.interior, res.x.interior)
    conv = convert.mixed_precision_mg(ref, lams)
    assert hasattr(conv.problem, "shift")
    assert conv.solve(tol=TOL, maxiter=2).residuals[2] == pytest.approx(
        rres.residuals[2], rel=1e-3)


def _dw_problem():
    pp = periodic_problem(3, 16, degree=2, shift=1.0, device="cpu")
    mg = MixedPrecisionMG(pp, 2, _cfg(), operator="kron",
                          residual="twofloat")
    return pp, mg


def test_periodic_3d_double_word_operator_has_four_histories():
    """The 3D shifted operator ([σM,M,M], [K,M,M], [M,K,M], [M,M,K]) needs 2
    u, 3 v and 4 distinct histories: K5's plan takes it (the cap was 3), and
    the CPU twin agrees with the reference's ``residual_kron_df`` to 1e-14
    of Σ|terms| (the two apply the same operations; XLA may fuse)."""
    pp, mg = _dw_problem()
    sp = sharing_plan(mg._plan_df.labels)
    assert [len(sp[k]) for k in ("u_lab", "v_src", "w_src", "term_w")] \
        == [2, 3, 4, 4]
    _, ints = twofloat._df_c_args(mg._plan_df)      # raised before the cap
    assert list(ints)[:4] == [2, 3, 4, 4]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(pp.space.npts)
    b = rng.standard_normal(pp.space.npts)
    (xh, xl), (bh, bl) = (twofloat.split_f64(torch.from_numpy(a))
                          for a in (x, b))
    rh, rl = mg._residual_dw(bh, bl, xh, xl)
    rp = ref_periodic.periodic_problem(3, 16, degree=2, shift=1.0)
    rA = ref_periodic._kron_periodic(rp.bands_1d, rp.shift, rp.space)
    rterms = tuple(tuple((jnp.asarray(h.numpy()), jnp.asarray(lo.numpy()))
                         for h, lo in term) for term in mg._terms_df)
    with jax.disable_jit():
        wh, wl = ref_residual_df(
            rterms, *(jnp.asarray(t.numpy()) for t in (bh, bl, xh, xl)),
            rp.space.pads, labels=rA._band_labels(),
            periodic=rp.space.periodic)
    got = twofloat.merge_f64(rh, rl).numpy()
    want = np.asarray(wh, np.float64) + np.asarray(wl, np.float64)
    A = pp.A.toarray()
    scale = np.abs(b) + (np.abs(A) @ np.abs(x).ravel()).reshape(x.shape)
    assert (np.abs(got - want) <= 1e-14 * scale).all()
    exact = b - (A @ x.ravel()).reshape(x.shape)
    assert (np.abs(got - exact) <= 1e-12 * scale).all()


@pytest.mark.parametrize("kind", ["twofloat", "dw"])
def test_periodic_3d_solves_match_jax(kind):
    """3D 16³ p2 periodic, kron: the twofloat defect correction and the
    dw-PCG take the reference's counts with its λ estimates and reach 1e-10
    with a true residual ≤ 5e-10."""
    with jax.disable_jit():
        rp = ref_periodic.periodic_problem(3, 16, degree=2, shift=1.0)
        if kind == "twofloat":
            ref = RefMG(rp, 2, _cfg(RefCycle, RefSmoother), operator="kron",
                        residual="twofloat")
            levels = ref.levels64
        else:
            ref = RefPCG(rp, 2, _cfg(RefCycle, RefSmoother), operator="kron",
                         precision="dw")
            levels = ref.levels
        lams = ref_lams(levels, ref.cfg.smoother)
        rres = ref.solve(tol=TOL, maxiter=60)
    pp = periodic_problem(3, 16, degree=2, shift=1.0, device="cpu")
    if kind == "twofloat":
        port = MixedPrecisionMG(pp, 2, _cfg(), operator="kron",
                                residual="twofloat")
    else:
        port = MGPreconditionedCG(pp, 2, _cfg(), operator="kron",
                                  precision="dw")
    port.lams = convert.lams(lams)
    res = port.solve(tol=TOL, maxiter=60)
    assert res.converged and rres.converged
    assert res.iterations == rres.iterations, (res.iterations,
                                               rres.iterations)
    for a, b in zip(res.residuals[:4], rres.residuals[:4]):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    r = pp.b.interior - pp.A.dot(res.x).interior
    assert float(torch.linalg.vector_norm(r)) <= 5e-10


def test_periodic_banded_defect_correction_and_bf16():
    """A banded periodic level under the f64 residual, f32 and bf16 cycles
    (2D 32 p3): both reach 1e-10, bf16 within twice the f32 count."""
    pp = periodic_problem(2, 32, degree=3, device="cpu")
    counts = {}
    for low in (torch.float32, torch.bfloat16):
        mg = MixedPrecisionMG(pp, 2, _cfg(), operator="banded",
                              residual="f64", low_dtype=low)
        res = mg.solve(tol=TOL, maxiter=60)
        assert res.converged
        r = pp.b.interior - pp.A.dot(res.x).interior
        assert float(torch.linalg.vector_norm(r)) <= 5e-10
        counts[low] = res.iterations
    assert counts[torch.bfloat16] <= 2 * counts[torch.float32]
