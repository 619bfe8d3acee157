"""K1's modes (apply, residual, dinv, cheb) and its launch data against the
JAX package, on the CPU.

The same numpy-seeded operator and fields go through ``poms_tpu`` and
through the port's mode wrapper, which runs its plain version for CPU
tensors: f32 within 1e-6 of max|y|, f64 within 1e-13 (the summation order is
the only difference).  The kernel's control data (stacked padded bands,
lifted geometry, runs of terms, sharing plan, diagonal rule, tiling) is
executed or checked in Python, where it can be tested without a card; the
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poms_tpu.core.kron import KroneckerSumOperator as RefKron
from poms_tpu.core.space import StencilVectorSpace as RefSpace
from poms_tpu.core.vector import StencilVector as RefVec
from poms_tpu.mg.smoother import chebyshev_step as ref_chebyshev_step
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector, ghost_pad
from poms_tpu_torch.mg.smoother import chebyshev_step
from poms_tpu_torch.ops import kron
from poms_tpu_torch.ops.kron import (CAPS, MODES, build_kron_plan,
                                     chunk_terms, kron_apply_plain,
                                     kron_mode, kron_tiling, plan_apply,
                                     sharing_plan)

torch.set_num_threads(1)

# npts, pads, periodic: 1D/2D/3D, ragged, periodic and mixed
CASES = [((40,), (3,), (False,)),
         ((33,), (2,), (True,)),
         ((17, 23), (3, 3), (False, False)),
         ((12, 16), (2, 1), (True, False)),
         ((9, 10, 11), (3, 3, 3), (False,) * 3),
         ((8, 6, 12), (2, 2, 2), (True,) * 3),
         ((7, 9, 5), (1, 3, 2), (False, True, False))]
TOL = {32: 1e-6, 64: 1e-13}
DT = {32: (jnp.float32, torch.float32), 64: (jnp.float64, torch.float64)}


def _bands(npts, pads, seed):
    """Poisson-shaped K and M bands per axis with a dominant centre column
    (the diagonal divides in dinv and cheb), and three fields."""
    rng = np.random.default_rng(seed)

    def band(n, p):
        return (rng.standard_normal((n, 2 * p + 1)) / 4
                + 2.0 * (np.arange(2 * p + 1) == p))

    Ks = [band(n, p) for n, p in zip(npts, pads)]
    Ms = [band(n, p) for n, p in zip(npts, pads)]
    return Ks, Ms, [rng.standard_normal(npts) for _ in range(3)]


def _pair(npts, pads, periodic, bits, seed=0):
    """The same Poisson-shaped operator and fields in both packages."""
    d = len(npts)
    Ks, Ms, fields = _bands(npts, pads, seed)
    jdt, tdt = DT[bits]
    ref_sp = RefSpace(npts=npts, pads=pads, periodic=periodic, dtype=jdt)
    Kj = [jnp.asarray(K, jdt) for K in Ks]
    Mj = [jnp.asarray(M, jdt) for M in Ms]
    ref = RefKron(ref_sp, [[Kj[b] if b == a else Mj[b] for b in range(d)]
                           for a in range(d)])
    sp = StencilVectorSpace(npts=npts, pads=pads, periodic=periodic,
                            dtype=tdt, device="cpu")
    Kt = [torch.as_tensor(K, dtype=tdt) for K in Ks]
    Mt = [torch.as_tensor(M, dtype=tdt) for M in Ms]
    op = KroneckerSumOperator(sp, [[Kt[b] if b == a else Mt[b]
                                    for b in range(d)] for a in range(d)])
    return (ref, op, [jnp.asarray(f, jdt) for f in fields],
            [torch.as_tensor(f, dtype=tdt) for f in fields])


def _rel(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("npts,pads,periodic", CASES)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("mode", ["apply", "residual", "dinv"])
def test_mode_matches_jax(npts, pads, periodic, bits, mode):
    ref, op, (xj, bj, _), (xt, bt, _) = _pair(npts, pads, periodic, bits)
    ax = ref.dot(RefVec.from_interior(ref.space, xj)).interior
    before = dict(kron_mode.launches)
    if mode == "apply":
        got, want = op._apply_interior(xt), ax
    elif mode == "residual":
        sp = op.space
        got = op.residual(StencilVector.from_interior(sp, xt),
                          StencilVector.from_interior(sp, bt))
        want = bj - ax
    else:   # the power iteration's inner step y = A x / diag
        got, want = op.dinv_apply(xt), ax / ref.diagonal()
    assert kron_mode.launches == before      # CPU tensors: plain versions
    assert tuple(got.shape) == npts
    assert _rel(got, want) <= TOL[bits]


@pytest.mark.parametrize("npts,pads,periodic", CASES)
@pytest.mark.parametrize("bits", [32, 64])
def test_cheb_update_matches_jax_step(npts, pads, periodic, bits):
    """One update of the mode, (c1, c2) and a direction given, against the
    same expression on the JAX operator."""
    ref, op, (xj, bj, dj), (xt, bt, dt) = _pair(npts, pads, periodic, bits, 1)
    c1, c2 = 0.375, 0.75
    ax = ref.dot(RefVec.from_interior(ref.space, xj)).interior
    z = (bj - ax) / ref.diagonal()
    first = c2 * z
    x_new, d_new = op.cheb_update(xt, bt, None, 0.0, c2)
    assert _rel(d_new, first) <= TOL[bits]
    assert _rel(x_new, xj + first) <= TOL[bits]
    later = c1 * dj + c2 * z
    x_new, d_new = op.cheb_update(xt, bt, dt.clone(), c1, c2)
    assert _rel(d_new, later) <= TOL[bits]
    assert _rel(x_new, xj + later) <= TOL[bits]


@pytest.mark.parametrize("npts,pads,periodic", CASES)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("degree", [1, 4])
def test_chebyshev_step_matches_jax(npts, pads, periodic, bits, degree):
    """The whole smoother application (``degree`` cheb passes, the scalars
    on the host) against the reference's chebyshev_step with its λ given.
    f32 is held to 1e-5: four dependent updates."""
    ref, op, (xj, bj, _), (xt, bt, _) = _pair(npts, pads, periodic, bits, 2)
    lam = 2.5
    want = ref_chebyshev_step(ref, RefVec.from_interior(ref.space, xj),
                              RefVec.from_interior(ref.space, bj), lam,
                              degree=degree, fraction=16.0).interior
    x = StencilVector.from_interior(op.space, xt)
    x_before = xt.clone()
    got = chebyshev_step(op, x, StencilVector.from_interior(op.space, bt),
                         lam, degree=degree, fraction=16.0).interior
    assert _rel(got, want) <= (1e-5 if bits == 32 else 1e-13)
    assert torch.equal(x.interior, x_before)      # the caller's x is kept


# -- the kernel's control data -----------------------------------------------

def _free_terms(npts, pads, n_terms, seed=3):
    """``n_terms`` terms that share no band."""
    rng = np.random.default_rng(seed)
    return [[torch.as_tensor(rng.standard_normal((n, 2 * p + 1)))
             for n, p in zip(npts, pads)] for _ in range(n_terms)]


def _poisson_terms(npts, pads, seed=4):
    Ks, Ms, _ = _bands(npts, pads, seed)
    Kt, Mt = [torch.as_tensor(K) for K in Ks], [torch.as_tensor(M) for M in Ms]
    d = len(npts)
    return [[Kt[b] if b == a else Mt[b] for b in range(d)] for a in range(d)]


@pytest.mark.parametrize("npts,pads,periodic", CASES)
@pytest.mark.parametrize("kind", ["poisson", "free4", "free1"])
def test_plan_evaluator_equals_plain(npts, pads, periodic, kind):
    """The plan executed by the Python evaluator (stacked zero-padded bands,
    lifted axes, runs of terms, shared partials) is A·x: bit for bit with
    one contraction per history (the double-word kernel's last stage), to
    summation order with the sums before the last contraction (K1's).  A·x
    is the plan's operator: in 1D the four free terms differ on their one
    axis and fold into one (``fold_terms``), within 1e-13 of the four."""
    terms = (_poisson_terms(npts, pads) if kind == "poisson"
             else _free_terms(npts, pads, int(kind[-1])))
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(npts))
    plan = build_kron_plan(terms, npts, pads, periodic)
    assert plan.n_terms == (1 if len(npts) == 1 else len(terms))
    want = kron_apply_plain(plan.terms, x, npts, pads, periodic)
    assert torch.equal(plan_apply(plan, x, presum=False), want)
    assert _rel(plan_apply(plan, x), want.numpy()) <= 1e-13
    unfolded = kron_apply_plain(terms, x, npts, pads, periodic)
    assert _rel(plan_apply(plan, x), unfolded.numpy()) <= 1e-13
    for sp in plan.plans:
        assert len(sp["u_lab"]) <= CAPS["u"] and len(sp["v_src"]) <= CAPS["v"]
        assert len(sp["g_lab"]) <= CAPS["g"]
    assert sorted(r for c in plan.chunks for r in c) == list(
        range(plan.n_terms))


def test_poisson_plan_is_seven_passes():
    """3D Poisson: 2 axis-2, 3 axis-1 and 2 axis-0 contractions in one
    launch (8 without the sum before the last axis, 9 term by term)."""
    npts, pads = (9, 10, 11), (3, 3, 3)
    plan = build_kron_plan(_poisson_terms(npts, pads), npts, pads,
                           (False,) * 3)
    assert plan.chunks == [[0, 1, 2]]
    sp = plan.plans[0]
    assert sp["u_lab"] == [0, 1]
    assert list(zip(sp["v_src"], sp["v_lab"])) == [(0, 0), (0, 1), (1, 0)]
    assert sp["g_lab"] == [0, 1] and sp["g_mult"] == [[1, 0, 0], [0, 1, 1]]
    assert len(sp["u_lab"]) + len(sp["v_src"]) + len(sp["g_lab"]) == 7
    assert len(sp["u_lab"]) + len(sp["v_src"]) + len(sp["w_src"]) == 8
    assert sp["term_w"] == [0, 1, 2]
    ints = kron._plan_ints(sp)
    assert len(ints) == 3 + CAPS["u"] + 2 * CAPS["v"] + CAPS["g"] \
        + CAPS["g"] * CAPS["v"]
    assert ints[:3] == [2, 3, 2] and ints[-6:] == [1, 0, 0, 0, 1, 1]


def test_four_free_terms_take_two_launches():
    npts, pads = (6, 7, 8), (2, 2, 2)
    plan = build_kron_plan(_free_terms(npts, pads, 4), npts, pads,
                           (False,) * 3)
    assert plan.chunks == [[0, 1], [2, 3]]
    labels = plan.labels
    assert chunk_terms(labels, {"u": 4, "v": 4, "g": 4}) == [[0, 1, 2, 3]]
    assert chunk_terms(labels, {"u": 1, "v": 1, "g": 1}) == [[0], [1], [2],
                                                             [3]]
    # two equal terms end in the same partial: the sum counts it twice
    t = _free_terms(npts, pads, 1)
    twice = sharing_plan(build_kron_plan(t + t, npts, pads,
                                         (False,) * 3).labels)
    assert twice["g_mult"] == [[2]] and twice["term_w"] == [0, 0]


@pytest.mark.parametrize("npts,pads,periodic", CASES)
@pytest.mark.parametrize("bits", [32, 64])
def test_kernel_diagonal_rule_is_bitwise_diagonal(npts, pads, periodic, bits):
    """Σ_r ((c0·c1)·c2) over the centre columns, terms added in order: the
    bits of KroneckerSumOperator.diagonal() and of the JAX diagonal."""
    ref, op, _, _ = _pair(npts, pads, periodic, bits, 6)
    assert torch.equal(op.plan.diagonal(), op.diagonal())
    np.testing.assert_array_equal(op.plan.diagonal().numpy(),
                                  np.asarray(ref.diagonal()))


@pytest.mark.parametrize("npts,pads,periodic", CASES)
def test_plan_geometry_and_bands(npts, pads, periodic):
    terms = _poisson_terms(npts, pads)
    plan = build_kron_plan(terms, npts, pads, periodic)
    lead = 3 - len(npts)
    assert plan.n3 == (1,) * lead + npts and plan.P >= max(pads)
    assert plan.P in kron.COMPILED_P
    W = 2 * plan.P + 1
    for a in range(3):
        assert plan.bands[a].shape[1:] == (plan.n3[a], W)
        assert plan.cols[a].shape == (len(terms), plan.n3[a])
    for a in range(lead):    # the lifted axes: one identity band
        assert plan.bands[a].shape[0] == 1
        assert float(plan.bands[a][0, 0, plan.P]) == 1.0
        assert float(plan.bands[a].abs().sum()) == 1.0
    # a band sits centred in its zero padding
    p = pads[-1]
    centre = plan.bands[2][plan.labels[2][0]][:, plan.P - p:plan.P + p + 1]
    assert torch.equal(centre, terms[0][-1])
    assert float(plan.bands[2].abs().sum()) == pytest.approx(
        float(sum(B.abs().sum() for B in {id(t[-1]): t[-1]
                                          for t in terms}.values())))


@pytest.mark.parametrize("n3", [(129,) * 3, (65,) * 3, (33,) * 3, (17,) * 3,
                                (9,) * 3, (1, 1, 1 << 20), (1, 1025, 1025),
                                (8, 8, 128), (1, 1, 5), (300, 2, 700)])
@pytest.mark.parametrize("P,threads,cols", [(1, 256, 2), (3, 256, 2),
                                            (3, 256, 1), (2, 256, 1)])
def test_tiling_fits_a_block(n3, P, threads, cols):
    itemsize = 4 if cols == 2 else 8
    for rows in kron.rows_options():
        extra = kron.warp_widths(cols, rows)
        T1, T2, chunk = kron_tiling(n3, P, threads,
                                    kron.k1_step_cost(itemsize, P, rows),
                                    cols=cols, rows=rows, extra=extra)
        assert 1 <= T1 < n3[1] + rows and 1 <= chunk <= n3[0]
        assert 1 <= T2 < n3[2] + cols and T2 % cols == 0 and T1 % rows == 0
        assert (T1 // rows) * (T2 // cols) <= threads
        # tiles divide the axes evenly: the last one misses at most
        # ``rows`` (``cols``) points per tile of its axis
        tiles1, tiles2 = -(-n3[1] // T1), -(-n3[2] // T2)
        assert 0 <= tiles1 * T1 - n3[1] < rows * tiles1
        ragged = tiles2 * T2 - n3[2]
        if T2 in extra and ragged >= cols * tiles2:
            # but for a width whose row groups fill whole warps (K1 at two
            # rows a thread), ragged by design: it is offered only narrower
            # than the axis, so its last tile holds a point and fewer than
            # half its columns idle (11% at 513, 20% at 257, 47% at 17,
            # where the 16-wide tile measured 3-6% faster on an H100 than
            # the even 18-wide one)
            assert T2 < n3[2] and ragged < T2 and 2 * ragged < tiles2 * T2
        else:
            assert 0 <= ragged < cols * tiles2


@pytest.mark.parametrize("n,rows,tiling", [
    (513, 2, (16, 64, 65)), (257, 2, (18, 52, 37)), (129, 1, (11, 44, 19)),
    (65, 1, (13, 34, 5)), (33, 1, (17, 18, 1)), (17, 1, (9, 18, 1)),
    (9, 1, (9, 10, 1))])
def test_tiling_model_at_the_level_shapes(n, rows, tiling):
    """K1's cost model (f32, p = 3, two columns a thread, 132 SMs) picks
    these micro-tile heights and tilings at the headline solve's level
    shapes: two rows a thread on the fine grids, one on the coarse ones;
    each was the best of a sweep of both heights on an H100 or within 4%
    of it (`bench/k1_compare.py --sweep`)."""
    assert kron.k1_tiling((n,) * 3, 3, 4) == (rows, tiling)


def test_k1_step_cost_shape():
    """The model's terms: a second wave of blocks costs, more planes cost,
    f64 (255 registers a thread) fits one 256-thread block an SM where f32
    fits two, a row group that fills its warps costs less than
    one whose warps reach into the next row, and a block over the card's
    shared memory cannot run."""
    f32, f64 = kron.k1_step_cost(4, 3, 2), kron.k1_step_cost(8, 3, 2)
    one_wave = f32(16, 64, 256, 65, 264, 132)
    assert f32(16, 64, 256, 65, 265, 132) > 1.9 * one_wave
    assert f32(16, 64, 256, 66, 264, 132) > one_wave
    assert f64(16, 64, 256, 65, 264, 132) == pytest.approx(
        2 * f64(16, 64, 256, 65, 132, 132))
    assert f32(16, 64, 256, 65, 132, 132) < one_wave   # half-filled SMs
    assert f32(16, 58, 256, 65, 264, 132) > one_wave   # 29 lanes a row
    assert f32(16, 64, 256, 4000, 264, 132) == math.inf
    assert kron.columns_per_thread(4) == 2
    assert kron.columns_per_thread(8) == 1
    assert kron.rows_options() == (2, 1)
    assert kron.warp_widths(2, 2) == (16, 32, 64)
    assert kron.warp_widths(1, 2) == (8, 16, 32)
    assert kron.warp_widths(2, 1) == kron.warp_widths(1, 1) == ()


def test_kron_mode_argument_checks():
    _, op, _, (xt, bt, _) = _pair((5, 6, 7), (2, 2, 2), (False,) * 3, 64)
    with pytest.raises(ValueError):
        kron_mode("smooth", op.plan, xt)
    with pytest.raises(ValueError):
        kron_mode("residual", op.plan, xt)     # needs b
    with pytest.raises(ValueError):
        kron_mode("apply", op.plan, xt, b=bt)  # takes no b
    with pytest.raises(NotImplementedError):
        kron_mode("apply", op.plan, xt.to("meta"))
    assert MODES == ("apply", "residual", "dinv", "cheb")


def test_vector_from_interior_pads_on_demand():
    """A vector made from an interior holds no padded copy until ``data``
    is read; then the interior is a view of the zero-ghosted field."""
    sp = StencilVectorSpace(npts=(4, 5), pads=(2, 1), device="cpu")
    x = torch.arange(20, dtype=torch.float64).reshape(4, 5)
    v = StencilVector.from_interior(sp, x)
    assert v._data is None and v.interior is x
    assert torch.equal(v.data, ghost_pad(x, sp.pads, (False, False)))
    assert v._interior is None and torch.equal(v.interior, x)
    assert v.interior.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("npts,pads,periodic", CASES)
def test_bf16_modes_are_the_f32_modes_rounded_once(npts, pads, periodic):
    """K1's bf16 instantiation computes in f32 and rounds on the store, and
    so does its plain version: every mode of a bf16 operator equals the f32
    operator of the same (bf16-valued) bands on the cast fields, rounded."""
    bf16, f32 = torch.bfloat16, torch.float32
    _, op32, _, fields = _pair(npts, pads, periodic, 32, seed=3)
    cast = {}
    terms = [[cast.setdefault(id(B), B.to(bf16)) for B in term]
             for term in op32.terms]
    low = KroneckerSumOperator(op32.space.with_dtype(bf16), terms)
    hi = KroneckerSumOperator(op32.space, [[B.to(f32) for B in term]
                                           for term in low.terms])
    x, b, d = (f.to(bf16) for f in fields)
    x32, b32, d32 = (f.to(f32) for f in (x, b, d))
    assert torch.equal(low._apply_interior(x),
                       hi._apply_interior(x32).to(bf16))
    assert torch.equal(low.dinv_apply(x), hi.dinv_apply(x32).to(bf16))
    sp, sp32 = low.space, hi.space
    assert torch.equal(
        low.residual(StencilVector.from_interior(sp, x),
                     StencilVector.from_interior(sp, b)),
        hi.residual(StencilVector.from_interior(sp32, x32),
                    StencilVector.from_interior(sp32, b32)).to(bf16))
    for dd, dd32 in ((None, None), (d, d32)):
        got = low.cheb_update(x, b, dd, 0.3, 0.7)
        want = hi.cheb_update(x32, b32, dd32, 0.3, 0.7)
        assert all(torch.equal(g, w.to(bf16)) for g, w in zip(got, want))
    assert low.plan.tcols == hi.plan.tcols      # the f32 kernel's tile
