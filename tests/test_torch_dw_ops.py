"""K6's plain versions and K5's sign operand against the JAX package.

On the CPU the port's double-word reductions (``dw_dot_stack``, ``dw_dot``,
``dw_norm2``, ``dw_sum_tree``) run the pairwise tree in the reference's
order, and ``dw_update`` runs the elementwise lines of the reference's
``step_dw`` / ``step_tf`` / ``step_dwrr`` / ``precond_dw``.  The same numpy
inputs go through both.  Eager JAX compiles each primitive alone, so the
error-free transformations agree bitwise; ``dw_mul`` may contract
``xh*yl + xl*yh`` into an FMA on the JAX side, so what passes through it is
held to 1e-13 relative after ``merge_f64`` (as tests/test_torch_twofloat.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poms_tpu.ops import twofloat as ref
from poms_tpu_torch.ops import twofloat as port

torch.set_num_threads(1)

SIZES = [1, 2, 7, 64, 1000, 4097]


def _pair(n, seed, scale=1.0):
    """An f64 vector split into (hi, lo) words, as JAX arrays and tensors."""
    x = np.random.default_rng(seed).standard_normal(n) * scale
    return ref.split_f64(jnp.asarray(x)), port.split_f64(torch.from_numpy(x))


def _f32(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(got, want, tol=1e-13):
    want = np.asarray(want)
    assert want.dtype == np.float64
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (got, want)


@pytest.mark.parametrize("n", SIZES)
def test_sum_tree_bitwise(n):
    """The tree itself is dw_add alone: the same bits."""
    (jh, jl), (th, tl) = _pair(n, n)
    want = np.asarray(ref.dw_sum_tree(jh, jl))
    got = port.dw_sum_tree(th, tl)
    assert got.shape == () and got.dtype == torch.float64
    assert got.numpy() == want
    assert port.dw_sum_tree_plain(th, tl).numpy() == want


@pytest.mark.parametrize("n", SIZES)
def test_dot_and_norm_match_jax(n):
    (xjh, xjl), (xth, xtl) = _pair(n, n + 1)
    (yjh, yjl), (yth, ytl) = _pair(n, n + 2, 1e-3)
    _close(port.dw_dot(xth, xtl, yth, ytl), ref.dw_dot(xjh, xjl, yjh, yjl))
    _close(port.dw_norm2(xth, xtl), ref.dw_norm2(xjh, xjl))
    # against the f64 values: ~49 bits
    x64 = xth.double() + xtl.double()
    y64 = yth.double() + ytl.double()
    assert abs(float(port.dw_dot(xth, xtl, yth, ytl)) - float(x64 @ y64)) \
        <= 1e-13 * float(x64.abs() @ y64.abs())
    assert abs(float(port.dw_norm2(xth, xtl))
               - float(torch.linalg.vector_norm(x64))) \
        <= 1e-13 * float(torch.linalg.vector_norm(x64))


@pytest.mark.parametrize("n", [7, 1000])
def test_dot_stack_matches_jax_and_single_dots(n):
    (xjh, xjl), (xth, xtl) = _pair(n, 3)
    (yjh, yjl), (yth, ytl) = _pair(n, 4)
    zj, zt = _f32(n, 5)
    zzj = jnp.zeros_like(zj)
    want = ref.dw_dot_stack([(zj, zzj, xjh, xjl), (zj, zzj, yjh, yjl)])
    got = port.dw_dot_stack([(zt, None, xth, xtl), (zt, None, yth, ytl)])
    assert got.shape == (2,) and got.dtype == torch.float64
    _close(got, want)
    # a None low word gives the bits of explicit zeros
    zzt = torch.zeros_like(zt)
    assert torch.equal(got, port.dw_dot_stack([(zt, zzt, xth, xtl),
                                               (zt, zzt, yth, ytl)]))
    # and each entry is the single dot (the batched tree pairs alike)
    assert got[0] == port.dw_dot(zt, None, xth, xtl)
    assert got[1] == port.dw_dot(zt, zzt, yth, ytl)
    # six dots: more than one kernel pass would take on the card
    six = port.dw_dot_stack([(zt, None, xth, xtl)] * 6)
    assert six.shape == (6,) and bool((six == got[0]).all())


def test_reductions_take_any_shape():
    (_, _), (th, tl) = _pair(24, 9)
    flat = port.dw_norm2(th, tl)
    assert port.dw_norm2(th.reshape(2, 3, 4), tl.reshape(2, 3, 4)) == flat
    assert port.dw_norm2(th, None) == port.dw_norm2(th, torch.zeros_like(th))


# -- K6u's plain versions against the reference's lines -----------------------

def _scalars(*vals):
    return ([jnp.asarray(v, jnp.float64) for v in vals],
            [torch.tensor(v, dtype=torch.float64) for v in vals])


def test_update_cg_matches_step_dw_lines():
    """poms_tpu/mg/mixed.py:511-516."""
    n = 500
    (xjh, xjl), (xth, xtl) = _pair(n, 11)
    (rjh, rjl), (rth, rtl) = _pair(n, 12, 1e-4)
    (ajh, ajl), (ath, atl) = _pair(n, 13)
    pj, pt = _f32(n, 14)
    (rzj, papj), (rzt, papt) = _scalars(0.37, 1.91)
    a_h, a_l = ref.split_f64(rzj / papj)
    dxh, dxl = ref.dw_mul(a_h, a_l, pj, jnp.zeros_like(pj))
    wxh, wxl = ref.dw_add(xjh, xjl, dxh, dxl)
    wdh, wdl = ref.dw_mul(-a_h, -a_l, ajh, ajl)
    wrh, wrl = ref.dw_add(rjh, rjl, wdh, wdl)
    got = port.dw_update("cg", xth, xtl, rth, rtl, pt, ath, atl, rzt, papt)
    assert len(got) == 6 and all(t.dtype == torch.float32 for t in got)
    for (gh, gl), (wh, wl) in ((got[0:2], (wxh, wxl)), (got[2:4], (wrh, wrl)),
                               (got[4:6], (wdh, wdl))):
        _close(port.merge_f64(gh, gl), ref.merge_f64(wh, wl))


def test_update_direction_defect_dwrr_scalings_bitwise():
    """No dw_mul on these lines (mixed.py:527, :193-200, :547-548,
    :500-505): f32 multiplies, adds, two_prod and dw_add agree bitwise;
    the dwrr x-update passes through dw_mul and is held to 1e-13."""
    n = 300
    zj, zt = _f32(n, 21)
    pj, pt = _f32(n, 22)
    ej, et = _f32(n, 23)
    (xjh, xjl), (xth, xtl) = _pair(n, 24)
    (sj, rzj, rnj, papj), (st, rzt, rnt, papt) = _scalars(0.2, 0.37, 3e-7,
                                                          1.91)

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    same(port.dw_update("direction", zt, pt, st, rzt),
         zj + (sj / rzj).astype(jnp.float32) * pj)
    safe = jnp.where(rnj > 0, rnj, 1.0).astype(jnp.float32)
    ch, cl = ref.two_prod(ej, safe)
    wh, wl = ref.dw_add(xjh, xjl, ch, cl)
    gh, gl = port.dw_update("defect", xth, xtl, et, rnt)
    same(gh, wh)
    same(gl, wl)
    same(port.dw_update("div", zt, rnt), zj / safe)
    same(port.dw_update("mul", zt, rnt), zj * safe)
    zero_j, zero_t = _scalars(0.0)
    one = jnp.where(zero_j[0] > 0, zero_j[0], 1.0).astype(jnp.float32)
    same(port.dw_update("div", zt, zero_t[0]), zj / one)
    # dwrr: x += alpha p in double-word, dr = -f32(alpha) ap, rf += dr
    alpha = rzj / papj
    a_h, a_l = ref.split_f64(alpha)
    dxh, dxl = ref.dw_mul(a_h, a_l, pj, jnp.zeros_like(pj))
    wxh, wxl = ref.dw_add(xjh, xjl, dxh, dxl)
    dr = -alpha.astype(jnp.float32) * ej
    gxh, gxl, gdr, grf = port.dw_update("dwrr", xth, xtl, pt, et, zt, rzt,
                                        papt)
    _close(port.merge_f64(gxh, gxl), ref.merge_f64(wxh, wxl))
    same(gdr, dr)
    same(grf, zj + dr)
    only_x = port.dw_update("dwrr", xth, xtl, pt, None, None, rzt, papt)
    assert len(only_x) == 2
    assert torch.equal(only_x[0], gxh) and torch.equal(only_x[1], gxl)


def test_update_refuses_bad_calls():
    x = torch.zeros(4)
    s = torch.ones((), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown"):
        port.dw_update("axpy", x, s)
    with pytest.raises(ValueError, match="operands"):
        port.dw_update("div", x, s, s)
    with pytest.raises(ValueError, match="unknown"):
        port.dw_update_plain("axpy", x, s)
    assert set(port.UPDATE_MODES) == {"cg", "direction", "defect", "dwrr",
                                      "div", "mul"}


def test_step_dw_iterates_unchanged_by_the_wrappers():
    """One ``_step_dw`` through the wrappers equals the composition it
    replaced (explicit zero fields, two negations, host-side α split), bit
    for bit: the CPU iterates of the headline solve did not move."""
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem

    pp = poisson_problem(3, 8, degree=2, device="cpu", operator="kron")
    pcg = MGPreconditionedCG(pp, 2, CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)),
        operator="kron", precision="dw")
    state = pcg._start(pp.b)[0]
    xh, xl, rh, rl, z, p, rz = state
    new = pcg._step_dw(*state)
    sp = pp.space
    zp = torch.zeros_like(p)
    nh, nl = port.residual_kron_df(pcg._terms_df, zp, zp, p, zp, sp.pads,
                                   labels=pcg._labels, periodic=sp.periodic)
    aph, apl = -nh, -nl
    alpha = rz / port.dw_dot(p, zp, aph, apl)
    a_h, a_l = port.split_f64(alpha)
    oxh, oxl = port.dw_add(xh, xl, *port.dw_mul(a_h, a_l, p, zp))
    drh, drl = port.dw_mul(-a_h, -a_l, aph, apl)
    orh, orl = port.dw_add(rh, rl, drh, drl)
    rn = port.dw_norm2(orh, orl)
    for got, want in zip(new[:4] + (new[7],), (oxh, oxl, orh, orl, rn)):
        assert torch.equal(got, want)


# -- K6u's ``out``: results written into given fields --------------------------

# mode, whether dwrr's ap and rf are given, and for each result the operand
# it overwrites in the solvers' in-place use (None: a fresh field)
OUT_CASES = [("cg", True, (0, 1, 2, 3, None, None)),
             ("direction", True, (1,)), ("defect", True, (0, 1)),
             ("dwrr", True, (0, 1, None, 4)), ("dwrr", False, (0, 1)),
             ("div", True, (0,)), ("mul", True, (0,))]


def _update_operands(mode, with_ap, n=37):
    """Operands of ``dw_update(mode, ...)`` on CPU f32 fields (low words
    small) and positive f64 scalars."""
    g = torch.Generator().manual_seed(len(mode))
    f = [torch.randn(n, generator=g) for _ in range(7)]
    for k in (1, 3, 6):
        f[k] *= 1e-8
    s0 = torch.tensor(0.37, dtype=torch.float64)
    s1 = torch.tensor(1.91, dtype=torch.float64)
    n_in, n_s, _ = port.UPDATE_MODES[mode]
    fields = f[:n_in]
    if not with_ap:
        fields[3] = fields[4] = None
    return fields + [s0, s1][:n_s]


@pytest.mark.parametrize("mode,with_ap,alias", OUT_CASES,
                         ids=[f"{m}{'' if a else '-x'}"
                              for m, a, _ in OUT_CASES])
def test_dw_update_out_is_bit_equal_to_the_allocating_call(mode, with_ap,
                                                           alias):
    """``out`` given, fresh or aliasing the operands as the in-place step
    uses them: the same words as the allocating call, returned as the out
    fields themselves; a wrong count, dtype or shape raises."""
    ops = _update_operands(mode, with_ap)
    want = port.dw_update(mode, *ops)
    want = (want,) if isinstance(want, torch.Tensor) else want
    assert len(want) == len(alias)
    first = ops[0]
    fresh = [torch.full_like(first, float("nan")) for _ in alias]
    got = port.dw_update(mode, *ops, out=fresh)
    got = (got,) if isinstance(got, torch.Tensor) else got
    assert all(g is b for g, b in zip(got, fresh))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ops = [t.clone() if t is not None else None for t in ops]
    out = [ops[j] if j is not None else torch.empty_like(first)
           for j in alias]
    got = port.dw_update(mode, *ops, out=out)
    got = (got,) if isinstance(got, torch.Tensor) else got
    assert all(g is b for g, b in zip(got, out))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="writes"):
        port.dw_update(mode, *ops, out=fresh + [fresh[0]])
    with pytest.raises(TypeError):
        port.dw_update(mode, *ops, out=[t.double() for t in fresh])
    with pytest.raises(ValueError, match="expected"):
        port.dw_update(mode, *ops, out=[t[1:] for t in fresh])
    with pytest.raises(ValueError, match="expected"):
        port.dw_update(mode, *ops, out=[torch.empty(2 * first.numel())[::2]
                                        for _ in fresh])


def _dw_pcg(n_el, degree):
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem

    pp = poisson_problem(3, n_el, degree=degree, device="cpu",
                         operator="kron")
    return pp, MGPreconditionedCG(pp, 2, CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)),
        operator="kron", precision="dw")


def test_inplace_step_dw_writes_its_own_buffers():
    """``_step_dw(..., inplace=True)`` on distinct buffers, as a captured
    graph holds them: x, r, z and p come back as those buffers, with the
    allocating step's words, and ρ and ‖r‖ equal."""
    pp, pcg = _dw_pcg(8, 2)
    state = pcg._start(pp.b)[0]
    want = pcg._step_dw(*state)
    bufs = [t.clone() for t in state]
    got = pcg._step_dw(*bufs, inplace=True)
    assert all(g is b for g, b in zip(got[:6], bufs[:6]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_dw_solves_leave_the_right_hand_side_unchanged():
    """16^3 p3: ``solve`` leaves the caller's b and ``solve_compiled`` the
    caller's ``b_pair`` as they were, word for word."""
    pp, pcg = _dw_pcg(16, 3)
    b = pp.b.interior.clone()
    res = pcg.solve(tol=1e-10, maxiter=30)
    assert res.converged and torch.equal(pp.b.interior, b)
    pair = port.split_f64(pp.b.interior)
    kept = [t.clone() for t in pair]
    _, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=30, b_pair=pair)
    assert it == res.iterations and float(rn) == res.residuals[-1]
    assert all(torch.equal(t, k) for t, k in zip(pair, kept))


# -- K5's sign operand -------------------------------------------------------------

@pytest.mark.parametrize("npts,pads", [((9, 10, 11), (2, 2, 2)),
                                       ((12, 13), (3, 1)), ((40,), (2,))])
def test_k5_negate_is_the_negated_pair(npts, pads):
    """``negate=True`` returns −r word by word: bit-equal to negating the
    old result, also with the zero flags of the A·p call."""
    rng = np.random.default_rng(sum(npts))
    d = len(npts)
    Ks = [rng.standard_normal((n, 2 * p + 1)) for n, p in zip(npts, pads)]
    Ms = [rng.standard_normal((n, 2 * p + 1)) for n, p in zip(npts, pads)]
    split = [(port.split_f64(torch.from_numpy(K)),
              port.split_f64(torch.from_numpy(M))) for K, M in zip(Ks, Ms)]
    tdf = [[split[b][0] if b == a else split[b][1] for b in range(d)]
           for a in range(d)]
    xh, xl = port.split_f64(torch.from_numpy(rng.standard_normal(npts)))
    bh, bl = port.split_f64(torch.from_numpy(rng.standard_normal(npts)))
    for args in ((bh, bl, xh, xl), (None, None, xh, None)):
        rh, rl = port.residual_kron_df(tdf, *args, pads)
        nh, nl = port.residual_kron_df(tdf, *args, pads, negate=True)
        assert torch.equal(nh, -rh) and torch.equal(nl, -rl)
    # the JAX package's A·p composition (mixed.py:484-490) gives these words
    zj = jnp.zeros(npts, jnp.float32)
    tj = [[tuple(jnp.asarray(w.numpy()) for w in B) for B in term]
          for term in tdf]
    with jax.disable_jit():
        jh, jl = ref.residual_kron_df(tj, zj, zj, jnp.asarray(xh.numpy()), zj,
                                      pads)
    want = np.asarray(ref.merge_f64(-jh, -jl))
    got = port.merge_f64(nh, nl).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
