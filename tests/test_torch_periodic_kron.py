"""The periodic shifted-Helmholtz problem held in the Kronecker-sum form
(``periodic_problem(..., operator="kron")``): no band composed, the same A·x
as the banded form, the same hierarchy and solves as the banded problem's
``operator="kron"`` hierarchy, on the CPU."""
import numpy as np
import pytest
import torch

from poms_tpu.models import periodic as ref_periodic
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.periodic import (_band_from_1d,
                                            build_periodic_hierarchy,
                                            periodic_problem)
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.ops.kron import _lift_labels, chunk_terms

torch.set_num_threads(1)


def _cfg():
    return CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))


@pytest.mark.parametrize("shift", [1.0, 0.5])
def test_kron_problem_applies_the_banded_operator(shift):
    """16³ p3: A is a Kronecker-sum operator of the 1D circulant bands and
    no band; A·x equals the banded problem's on seeded random x."""
    kp = periodic_problem(3, 16, degree=3, shift=shift, operator="kron",
                          device="cpu")
    bp = periodic_problem(3, 16, degree=3, shift=shift, device="cpu")
    assert isinstance(kp.A, KroneckerSumOperator)
    assert not isinstance(kp.A, StencilMatrix)
    assert not hasattr(kp.A, "band_t")
    assert len(kp.A.terms) == 4
    assert torch.equal(kp.b.interior, bp.b.interior)
    rng = np.random.default_rng(7)
    x = StencilVector.from_interior(
        kp.space, torch.as_tensor(rng.standard_normal(kp.space.npts)))
    got = kp.A.dot(x).interior
    want = bp.A.dot(x).interior
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-13


def test_banded_stays_the_default_bit_for_bit():
    """``operator="banded"`` (the default) composes the band it composed
    before: bit-equal to the composition from the 1D bands, and to the JAX
    package's band to the rounding of its 3D products (1 ulp)."""
    dflt = periodic_problem(3, 16, degree=3, device="cpu")
    band = periodic_problem(3, 16, degree=3, operator="banded", device="cpu")
    assert isinstance(band.A, StencilMatrix)
    assert torch.equal(dflt.A.band_t, band.A.band_t)
    fresh = _band_from_1d(band.bands_1d, band.shift, band.space)
    assert torch.equal(band.A.band_t, fresh)
    rp = ref_periodic.periodic_problem(3, 16, degree=3)
    np.testing.assert_allclose(band.A.band_t.numpy(),
                               np.asarray(rp.A.band_t), rtol=4.5e-16, atol=0)


def test_an_unknown_operator_is_refused():
    with pytest.raises(ValueError, match="operator"):
        periodic_problem(3, 16, degree=3, operator="dense", device="cpu")
    prob = periodic_problem(3, 16, degree=3, operator="kron", device="cpu")
    with pytest.raises(ValueError, match="operator"):
        build_periodic_hierarchy(prob, 2, operator="dense")


def _same_levels(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert la.A.space.npts == lb.A.space.npts
        for ta, tb in zip(la.A.terms, lb.A.terms):
            for Ba, Bb in zip(ta, tb):
                assert torch.equal(Ba, Bb)
        assert la.A._band_labels() == lb.A._band_labels()
        for tas, tbs in ((la.prolong, lb.prolong),
                         (la.restrict, lb.restrict)):
            for ta, tb in zip(tas or (), tbs or ()):
                assert torch.equal(ta.w, tb.w) and torch.equal(ta.c0, tb.c0)
    assert torch.equal(a[-1].chol.L, b[-1].chol.L)


def test_the_kron_problem_gives_the_banded_problems_kron_hierarchy():
    """32³ p3, 3 levels: the hierarchy built from the kron problem (its A
    taken as the finest operator) is, bit for bit, the one the banded
    problem gives with ``operator="kron"``; the dw-PCG takes the same
    iterations on both, to the same bits."""
    kp = periodic_problem(3, 32, degree=3, operator="kron", device="cpu")
    bp = periodic_problem(3, 32, degree=3, device="cpu")
    kl = build_periodic_hierarchy(kp, 3, operator="kron")
    bl = build_periodic_hierarchy(bp, 3, operator="kron")
    assert kl[0].A is kp.A
    _same_levels(kl, bl)
    out = {}
    for name, prob in (("kron", kp), ("banded", bp)):
        sol = MGPreconditionedCG(prob, 3, _cfg(), operator="kron",
                                 precision="dw")
        out[name] = sol.solve(tol=1e-10, maxiter=60)
    assert out["kron"].converged and out["banded"].converged
    assert out["kron"].iterations == out["banded"].iterations
    assert torch.equal(out["kron"].x.interior, out["banded"].x.interior)


@pytest.mark.parametrize("dim", [2, 3])
def test_the_shifted_operator_takes_two_runs_of_terms_in_3d(dim):
    """The shifted operator keeps its terms (four in 3D: three distinct
    axis-0 bands σM, K, M), but K1's plan folds σ·M⊗M⊗M + K⊗M⊗M into
    (σM + K)⊗M⊗M: one run of terms in 2D and in 3D, so no partial sum is
    written between runs, as for Dirichlet Poisson."""
    prob = periodic_problem(dim, 16, degree=3, operator="kron", device="cpu")
    assert len(prob.A.terms) == dim + 1
    assert len(chunk_terms(_lift_labels(prob.A._band_labels()))) == \
        (2 if dim == 3 else 1)
    plan = prob.A.plan
    assert plan.n_terms == dim and plan.chunks == [list(range(dim))]
    assert len(chunk_terms(plan.labels)) == 1
    pois = poisson_problem(dim, 16, degree=3, operator="kron", device="cpu")
    assert len(chunk_terms(pois.A.plan.labels)) == 1
    assert plan.labels == pois.A.plan.labels


def test_an_unfoldable_four_term_operator_takes_two_runs():
    """Four 3D terms with three distinct axis-0 bands, no two of them
    sharing two axes' bands (σM⊗K⊗K, K⊗M⊗M, M⊗K⊗M, M⊗M⊗K): nothing folds
    and K1's caps split them into two runs, the path that writes and reads
    back a partial sum between them."""
    prob = periodic_problem(3, 16, degree=3, operator="kron", device="cpu")
    (S, _, _), (K0, M1, M2), (M0, K1, _), (_, _, K2) = prob.A.terms
    terms = [[S, K1, K2], [K0, M1, M2], [M0, K1, M2], [M0, M1, K2]]
    A = KroneckerSumOperator(prob.space, terms)
    assert A.plan.n_terms == 4 and A.plan.chunks == [[0, 1], [2, 3]]
    assert all(a is b for ta, tb in zip(A.plan.terms, A.terms)
               for a, b in zip(ta, tb))
    assert A.plan.labels[0] == [0, 1, 2, 2]
