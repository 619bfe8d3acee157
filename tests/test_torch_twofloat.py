"""The port's double-word toolbox against ``poms_tpu.ops.twofloat``.

The EFT building blocks run the same IEEE operations in the same order in
both packages (eager JAX compiles each primitive alone), so they must agree
bitwise.  Composite results are held to ≤ 1e-13 relative after merge_f64:
the JAX side may contract ``xh*yl + xl*yh`` in dw_mul into an FMA.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poms_tpu.ops import twofloat as ref
from poms_tpu_torch.ops import kron as kron_ops
from poms_tpu_torch.ops import twofloat as port

torch.set_num_threads(1)


def _both(a):
    """One numpy array as a JAX array and a torch tensor (same dtype)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()


def _f64_pair(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    assert x.dtype == np.float64
    return _both(x)


def _split_both(shape, seed, scale=1.0):
    xj, xt = _f64_pair(shape, seed, scale)
    return ref.split_f64(xj), port.split_f64(xt)


def _rel(got, want):
    want = np.asarray(want)
    assert want.dtype == np.float64, want.dtype
    return float(np.max(np.abs(_np(got) - want)) / np.max(np.abs(want)))


def test_split_merge_bitwise():
    (jh, jl), (th, tl) = _split_both((257,), 0)
    assert th.dtype == tl.dtype == torch.float32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    merged = np.asarray(ref.merge_f64(jh, jl))
    assert merged.dtype == np.float64
    np.testing.assert_array_equal(port.merge_f64(th, tl).numpy(), merged)


@pytest.mark.parametrize("fn", ["two_sum", "two_prod"])
def test_eft_bitwise(fn):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-3).astype(np.float32)
    (aj, at), (bj, bt) = _both(a), _both(b)
    for got, want in zip(getattr(port, fn)(at, bt), getattr(ref, fn)(aj, bj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s, e = getattr(port, fn)(at, bt)
    exact = (a.astype(np.float64) + b if fn == "two_sum"
             else a.astype(np.float64) * b)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  exact)


def test_dw_add_bitwise():
    (xjh, xjl), (xth, xtl) = _split_both((500,), 2)
    (yjh, yjl), (yth, ytl) = _split_both((500,), 3)
    for got, want in zip(port.dw_add(xth, xtl, yth, ytl),
                         ref.dw_add(xjh, xjl, yjh, yjl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dw_mul_and_mul_fd():
    (xj, xt), (yj, yt) = _split_both((500,), 4), _split_both((500,), 5)
    want = ref.merge_f64(*ref.dw_mul(*xj, *yj))
    assert _rel(port.merge_f64(*port.dw_mul(*xt, *yt)), want) <= 1e-13
    want = ref.merge_f64(*ref.dw_mul_fd(yj[0], *xj))
    assert _rel(port.merge_f64(*port.dw_mul_fd(yt[0], *xt)), want) <= 1e-13
    nh, nl = port.dw_neg(*xt)
    np.testing.assert_array_equal(nh.numpy(), -xt[0].numpy())
    np.testing.assert_array_equal(nl.numpy(), -xt[1].numpy())


@pytest.mark.parametrize("dim,n_el,degree", [(1, 32, 3), (2, 12, 2),
                                             (3, 6, 2), (3, 8, 3)])
def test_residual_kron_df_matches_jax(dim, n_el, degree):
    """The dw Kronecker residual on the Poisson operator, ≤ 1e-13 of
    max|r| against the JAX dw residual, and near the f64 residual."""
    from poms_tpu.models.poisson import poisson_problem as ref_problem
    from poms_tpu_torch import convert

    rp = ref_problem(dim, n_el, degree=degree, operator="kron")
    pp = convert.problem(rp)
    rng = np.random.default_rng(7)
    xj, xt = _both(rng.standard_normal(rp.space.npts))
    tdf = [[ref.split_f64(B) for B in term] for term in rp.A.terms]
    rj = ref.merge_f64(*ref.residual_kron_df(
        tdf, *ref.split_f64(rp.b.interior), *ref.split_f64(xj),
        rp.space.pads))
    seen = {}
    pdf = [[seen.setdefault(id(B), port.split_f64(B)) for B in term]
           for term in pp.A.terms]
    rt = port.merge_f64(*port.residual_kron_df(
        pdf, *port.split_f64(pp.b.interior), *port.split_f64(xt),
        pp.space.pads))
    assert _rel(rt, rj) <= 1e-13
    r64 = pp.b.interior - pp.A._apply_interior(xt)
    assert _rel(rt, r64.numpy()) <= 1e-12


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_dots_and_norm_match_jax(n):
    (xj, xt), (yj, yt) = _split_both((n,), 8, 1e-5), _split_both((n,), 9)
    assert _rel(port.dw_dot(*xt, *yt).reshape(1),
                np.asarray(ref.dw_dot(*xj, *yj)).reshape(1)) <= 1e-13
    assert _rel(port.dw_norm2(*xt).reshape(1),
                np.asarray(ref.dw_norm2(*xj)).reshape(1)) <= 1e-13
    assert _rel(port.dw_sum_tree(*xt).reshape(1),
                np.asarray(ref.dw_sum_tree(*xj)).reshape(1)) <= 1e-13
    got = port.dw_dot_stack([(*xt, *yt), (*yt, *xt), (*xt, *xt)])
    want = ref.dw_dot_stack([(*xj, *yj), (*yj, *xj), (*xj, *xj)])
    assert got.shape == (3,)
    for g, w in zip(got, np.asarray(want)):
        assert _rel(g.reshape(1), np.asarray(w).reshape(1)) <= 1e-13


def test_eft_exact_with_broadcast():
    """The check of tests/test_twofloat.py::
    test_eft_exact_under_jit_with_broadcast on the port's twin."""
    rng = np.random.default_rng(3)
    c64 = torch.from_numpy(rng.standard_normal((8, 1)))
    x64 = torch.from_numpy(rng.standard_normal((8, 16)))
    C, X = port.split_f64(c64), port.split_f64(x64)
    tru = c64 * x64
    zh, zl = port.dw_mul(*C, *X)
    err = (zh.double() + zl.double() - tru).abs().max()
    assert float(err) < 1e-13 * float(tru.abs().max()), float(err)
    p, e = port.two_prod(C[0], X[0])
    d = (p.double() + e.double() - C[0].double() * X[0].double()).abs().max()
    assert float(d) == 0.0, float(d)
    y64 = torch.from_numpy(rng.standard_normal((8, 16)))
    zh2, zl2 = port.dw_add(*port.dw_mul(*C, *X), *port.split_f64(y64))
    tru2 = tru + y64
    err2 = (zh2.double() + zl2.double() - tru2).abs().max()
    assert float(err2) < 1e-13 * float(tru2.abs().max()), float(err2)


# -- K5: the double-word Kronecker residual's wrapper ------------------------

def _dw_poisson(dim, n_el, degree):
    """The port's Poisson operator as double-word band pairs (sharing kept),
    with x and b as f64 fields."""
    from poms_tpu_torch.models.poisson import poisson_problem

    pp = poisson_problem(dim, n_el, degree=degree, operator="kron",
                         device="cpu")
    seen = {}
    tdf = [[seen.setdefault(id(B), port.split_f64(B)) for B in term]
           for term in pp.A.terms]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(pp.space.npts))
    return pp, tdf, x


@pytest.mark.parametrize("dim,n_el,degree", [(1, 32, 3), (2, 12, 2),
                                             (3, 6, 2), (3, 8, 3)])
def test_residual_kron_df_on_cpu_is_the_plain_version(dim, n_el, degree):
    pp, tdf, x = _dw_poisson(dim, n_el, degree)
    args = (*port.split_f64(pp.b.interior), *port.split_f64(x),
            pp.space.pads)
    before = port.residual_kron_df.launches
    got = port.residual_kron_df(tdf, *args)
    assert port.residual_kron_df.launches == before
    want = port.residual_kron_df_plain(tdf, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dim,n_el,degree", [(1, 32, 3), (2, 12, 2),
                                             (3, 8, 3)])
def test_residual_kron_df_zero_flags_give_the_bits_of_zeros(dim, n_el,
                                                            degree):
    """``xl=None`` and ``bh=bl=None`` stand for zero fields: the words
    equal those of explicit zeros (the A·p call of the dw-PCG step)."""
    pp, tdf, x = _dw_poisson(dim, n_el, degree)
    xh = x.to(torch.float32)
    zero = torch.zeros_like(xh)
    bh, bl = port.split_f64(pp.b.interior)
    pads = pp.space.pads
    for flags, explicit in (((None, None, xh, None), (zero, zero, xh, zero)),
                            ((bh, bl, xh, None), (bh, bl, xh, zero))):
        got = port.residual_kron_df(tdf, *flags, pads)
        want = port.residual_kron_df(tdf, *explicit, pads)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):
        port.residual_kron_df(tdf, bh, None, xh, None, pads)


def _two_prod_fma_model(a, b):
    """numpy model of the kernel's two_prod: p = fl(a·b), e = fl(a·b − p).
    The product of two f32 is exact in f64, and so is its difference from
    p, so e is one rounding of the exact error: what an FMA returns."""
    p = (a * b).astype(np.float32)
    exact = a.astype(np.float64) * b.astype(np.float64)
    return p, (exact - p.astype(np.float64)).astype(np.float32)


def test_two_prod_fma_form_equals_split_form_bitwise():
    """On 2²⁰ random pairs over 60 binades and on edge cases the port's
    two_prod gives the FMA form's (p, e) bit for bit (the JAX package's
    12|12-bit split form does too, except where the error term leaves the
    normal range and at rare pairs whose error sum it rounds, tested
    below).  The pair is exact down to |a·b| of 2⁻¹⁰² (e, 24 bits under p,
    would be subnormal)."""
    rng = np.random.default_rng(12)
    n = 1 << 20
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 2.0 ** -40, -2.0 ** 40,
                     1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24, 3.0, 1e-20, -7e15],
                    np.float32)
    ea, eb = np.meshgrid(edge, edge)
    a = np.concatenate([a, ea.ravel()])
    b = np.concatenate([b, eb.ravel()])
    p, e = port.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    mp, me = _two_prod_fma_model(a, b)
    np.testing.assert_array_equal(p.numpy(), mp)
    np.testing.assert_array_equal(e.numpy(), me)
    exact = a.astype(np.float64) * b.astype(np.float64)
    normal = (np.abs(exact) >= 2.0 ** -102) | (exact == 0.0)
    assert normal.sum() >= n            # 1e-20 · 1e-20 lies below the range
    np.testing.assert_array_equal((mp.astype(np.float64) + me)[normal],
                                  exact[normal])
    # below the stated range the error term is no longer exact
    tiny = np.float32(2.0 ** -60) * np.float32(1.0 + 2.0 ** -23)
    mp, me = _two_prod_fma_model(np.array([tiny]), np.array([tiny]))
    assert float(mp[0]) + float(me[0]) != float(tiny) * float(tiny)


def _k5_bands(n, histories):
    """Double-word bands at n³, p = 3: Poisson-shaped terms (3 histories) or
    the periodic shifted shape (4: S M M, K M M, M K M, M M K)."""
    rng = np.random.default_rng(n)

    def band():
        return port.split_f64(torch.from_numpy(rng.standard_normal((n, 7))))

    K, M = [band() for _ in range(3)], [band() for _ in range(3)]
    terms = [[K[b] if b == a else M[b] for b in range(3)] for a in range(3)]
    return ([[band(), M[1], M[2]]] if histories == 4 else []) + terms


# shared memory of the compiled K5 as its launch reports it on the card
# (k5_resources on an NVIDIA H100 80GB HBM3): (P, histories, T1, T2, chunk,
# rows) -> bytes of the kernel's K5Smem
K5_SMEM_ON_CARD = {(3, 3, 24, 20, 171, 2): 85760, (3, 3, 12, 20, 257, 1): 77456,
                   (3, 4, 32, 16, 512, 2): 176416,
                   (3, 4, 16, 16, 512, 1): 150688,
                   (3, 3, 26, 17, 43, 2): 61088, (3, 3, 9, 26, 26, 1): 39584,
                   (3, 3, 26, 19, 171, 2): 87200,
                   (3, 4, 32, 16, 256, 2): 119072,
                   (3, 3, 26, 19, 22, 2): 62160}


@pytest.mark.parametrize("n", [513, 512, 257, 129, 65, 33, 17, 9])
@pytest.mark.parametrize("histories", [3, 4])
def test_k5_tile_model_fits_a_block_at_each_height(n, histories):
    """The compiled K5's tile model (``k5_step_cost`` at each height of
    ``K5_ROWS``) gives every grid of the headline's levels a block that
    fits: at most 256 threads, T1 a multiple of the rows a thread, shared
    memory (``k5_smem_bytes``, the kernel's as the card reported it) within
    the card's limit, and the height it chooses is the cheaper one; at
    513³ with 3 histories it takes two rows a thread."""
    from poms_tpu_torch.ops.stencil import K2_SMEM

    for key, want in K5_SMEM_ON_CARD.items():
        assert port.k5_smem_bytes(*key) == want, key
    tdf = _k5_bands(n, histories)
    plan = port.build_kron_df_plan(tdf, (n,) * 3, (3,) * 3)
    assert plan.trows in port.K5_ROWS
    costs = {}
    for R in port.K5_ROWS:
        # the tile the model gives at R rows a thread alone
        cost = port.k5_step_cost(3, histories, rows=R)
        trows, (T1, T2, chunk) = kron_ops.k1_tiling(
            (n,) * 3, 3, 4, port.MAX_THREADS_DW, kron_ops.SM_COUNT, 1, (R,),
            lambda r: cost, lambda r: ())
        assert trows == R and T1 % R == 0 and T1 // R * T2 <= 256
        assert port.k5_smem_bytes(3, histories, T1, T2, chunk,
                                  R) <= K2_SMEM
        blocks = -(-n // T1) * -(-n // T2) * -(-n // chunk)
        costs[R] = cost(T1, T2, 32 * -(-(T1 // R) * T2 // 32), chunk,
                        blocks, kron_ops.SM_COUNT)
        if R == plan.trows:
            assert (T1, T2, chunk) == plan.tiling
    assert costs[plan.trows] == min(costs.values())
    if n == 513 and histories == 3:
        assert plan.trows == 2


def test_kron_df_plan_layout_and_limits():
    """K5's launch data: K1's plan of the hi bands, the lo bands stacked by
    the same labels (a lifted axis: hi 1, lo 0), the sharing plan in the
    kernel's fixed layout; an operator past the kernel's limits raises."""
    pp, tdf, _ = _dw_poisson(2, 12, 2)
    plan = port.build_kron_df_plan(tdf, pp.space.npts, pp.space.pads)
    assert plan.n3 == (1,) + pp.space.npts and plan.P == 2
    assert float(plan.bands[0][0, 0, 2]) == 1.0
    assert not plan.bands_lo[0].any()
    for hi, lo in zip(plan.bands, plan.bands_lo):
        assert hi.shape == lo.shape and hi.dtype == lo.dtype == torch.float32
    lab = plan.labels[2][0]
    assert torch.equal(plan.bands_lo[2][lab], tdf[0][1][1])
    T1, T2, _ = plan.tiling
    assert T1 % plan.trows == 0
    assert T1 // plan.trows * T2 <= port.MAX_THREADS_DW
    # K5 keeps its own cost model: at two rows a thread, tiles of 26 × 19,
    # 6 runs of 22 planes
    assert kron_ops.kron_tiling((129,) * 3, 3, port.MAX_THREADS_DW,
                                port.k5_step_cost(3, rows=2),
                                rows=2) == (26, 19, 22)
    geo, ints = port._df_c_args(plan)
    assert list(ints)[:4] == [2, 2, 2, 2]     # u, v, histories, terms
    assert len(ints) == 4 + sum(port.CAPS_DW[k] * m
                                for k, m in zip("uvwt", (1, 2, 2, 1)))
    assert list(geo)[:3] == [1, *pp.space.npts] and geo[6] == 2
    rng = np.random.default_rng(13)
    free = [[port.split_f64(torch.from_numpy(rng.standard_normal((9, 3))))
             for _ in range(2)] for _ in range(5)]
    # five sharing-free terms (each its own u, v and history) pass the caps:
    # they take runs of terms, one launch each (2 + 2 + 1 u partials)
    five = port.build_kron_df_plan(free, (9, 9), (1, 1))
    assert five.chunks == [[0, 1], [2, 3], [4]]
    geo, *runs = port._df_c_args(five)
    assert [list(r)[:4] for r in runs] == [[2, 2, 2, 2], [2, 2, 2, 2],
                                           [1, 1, 1, 1]]
    # the limits of one launch: 2 u, 3 v, 4 histories, 4 terms.  Four terms
    # with four histories fit (the periodic shifted 3D operator's shape: the
    # first axis' band differs in every term but two); a third axis-2 band
    # opens a second run
    assert port.CAPS_DW == {"u": 2, "v": 3, "w": 4, "t": 4}
    K, M, S = (port.split_f64(torch.from_numpy(rng.standard_normal((9, 3))))
               for _ in range(3))
    four = [[S, M, M], [K, M, M], [M, K, M], [M, M, K]]
    _, ints = port._df_c_args(port.build_kron_df_plan(four, (9,) * 3,
                                                      (1,) * 3))
    assert list(ints)[:4] == [2, 3, 4, 4]
    three_u = [[M, M, M], [M, M, K], [M, M, S]]
    plan = port.build_kron_df_plan(three_u, (9,) * 3, (1,) * 3)
    assert plan.chunks == [[0, 1], [2]]
    assert [list(r)[:4] for r in port._df_c_args(plan)[1:]] == [
        [2, 2, 2, 2], [1, 1, 1, 1]]
