"""Double-word f32 ("dw") arithmetic for residuals below the f32 floor.

Counterpart of ``poms_tpu.ops.twofloat``: error-free transformations
(Knuth two_sum, an exact two_prod) and double-word add/mul (Joldes, Muller &
Popescu, ACM TOMS 2017) on f32 pairs (hi, lo) whose sum carries ~49
mantissa bits, plus the double-word Kronecker residual and the dots and
norms of the dw-PCG recurrences.

Eager PyTorch runs each elementwise operation as its own kernel, so no
multiply is contracted with an add into an FMA across these lines.  The
toolbox keeps the JAX package's contraction-immune form anyway (every
product in two_prod is exact).

K5: for CUDA tensors :func:`residual_kron_df` launches the hand-written
kernel of ``csrc/kron_apply_dw.cu`` (or raises); for CPU tensors it runs
:func:`residual_kron_df_plain`.  The kernel performs the plain version's
operations in its order with adds and multiplies the compiler may not fuse,
so its words equal the plain version's.  ``residual_kron_df.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.ops import _build
from poms_tpu_torch.ops.kron import (KronPlan, band_labels, build_kron_plan,
                                     sharing_plan, stack_bands)

__all__ = ["split_f64", "merge_f64", "two_sum", "two_prod", "dw_add",
           "dw_mul", "dw_mul_fd", "dw_neg", "residual_kron_df",
           "residual_kron_df_plain", "build_kron_df_plan", "k5_step_cost",
           "eft_on_card",
           "dw_norm2", "dw_dot", "dw_sum_tree", "dw_dot_stack"]

# mirrored in csrc/kron_apply_dw.cu (kCU, kCV, kCW, kCT, kMaxThreads and the
# instantiated half-widths)
CAPS_DW = {"u": 2, "v": 3, "w": 3, "t": 4}
COMPILED_P_DW = (1, 2, 3, 5)
MAX_THREADS_DW = 256

_HI12 = -4096   # int32 mask 0xFFFFF000: sign, exponent, top 11+1 mantissa bits


def split_f64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f64 → (hi, lo) f32 with hi = f32(x), lo = f32(x − hi)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def merge_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi.to(torch.float64) + lo.to(torch.float64)


def two_sum(a, b):
    """Knuth two_sum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _fast_two_sum(a, b):
    """Dekker fast_two_sum (requires |a| >= |b|): s + e == a + b."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split_bits(a):
    """Exact 12|12-bit split of f32 by masking the low mantissa bits."""
    ah = (a.view(torch.int32) & _HI12).view(torch.float32)
    return ah, a - ah


def two_prod(a, b):
    """p + e == a·b exactly, from the four exact partial products of the
    12|12-bit splits summed by an error-free two_sum cascade."""
    ah, al = _split_bits(a)
    bh, bl = _split_bits(b)
    hh = ah * bh
    hl = ah * bl
    lh = al * bh
    ll = al * bl
    s1, e1 = two_sum(hl, lh)
    s2, e2 = two_sum(hh, s1)
    s3, e3 = two_sum(s2, ll)
    return _fast_two_sum(s3, (e1 + e2) + e3)


def dw_add(xh, xl, yh, yl):
    """Double-word + double-word (AccurateDWPlusDW)."""
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = _fast_two_sum(sh, c)
    w = tl + vl
    return _fast_two_sum(vh, w)


def dw_mul(xh, xl, yh, yl):
    """Double-word × double-word (DWTimesDW)."""
    ph, pl = two_prod(xh, yh)
    t = xh * yl + xl * yh
    return _fast_two_sum(ph, pl + t)


def dw_mul_fd(a, xh, xl):
    """f32 × double-word."""
    ph, pl = two_prod(a, xh)
    return _fast_two_sum(ph, pl + a * xl)


def dw_neg(xh, xl):
    return -xh, -xl


def _apply_band_1d_axis_df(b1h, b1l, xh, xl, axis: int, pad: int,
                           periodic: bool = False):
    """Double-word twin of ``apply_band_1d_axis``:
    y[..., i, ...] = Σ_t band1[i, t] · x_pad[..., i + t, ...]."""
    n = xh.shape[axis]
    nd = xh.ndim
    pads = [pad if b == axis else 0 for b in range(nd)]
    xph = ghost_pad(xh, pads, [periodic] * nd)
    xpl = ghost_pad(xl, pads, [periodic] * nd)
    bshape = [1] * nd
    bshape[axis] = n
    oh = ol = None
    for t in range(2 * pad + 1):
        ch = b1h[:, t].reshape(bshape)
        cl = b1l[:, t].reshape(bshape)
        th, tl = dw_mul(ch, cl, xph.narrow(axis, t, n), xpl.narrow(axis, t, n))
        if oh is None:
            oh, ol = th, tl
        else:
            oh, ol = dw_add(oh, ol, th, tl)
    return oh, ol


def residual_kron_df_plain(terms_df: Sequence[Sequence[Tuple]], bh, bl, xh,
                           xl, pads, labels=None, periodic=None):
    """Plain PyTorch K5: r = b − (Σ_r ⊗_a B_r^(a))·x in double-word f32,
    axis passes right to left, partials shared along ``labels``, taps and
    terms added in order."""
    d = xh.ndim
    if labels is None:
        labels = band_labels([[B[0] for B in term] for term in terms_df])
    if periodic is None:
        periodic = (False,) * d
    partials = {r: (xh, xl) for r in range(len(terms_df))}
    hist = {r: () for r in range(len(terms_df))}
    for a in range(d - 1, -1, -1):
        cache = {}
        for r, term in enumerate(terms_df):
            key = hist[r] + (labels[a][r],)
            if key not in cache:
                ph, plo = partials[r]
                cache[key] = _apply_band_1d_axis_df(
                    term[a][0], term[a][1], ph, plo, a, pads[a], periodic[a])
            partials[r] = cache[key]
            hist[r] = key
    axh = axl = None
    for r in partials:
        ph, plo = partials[r]
        if axh is None:
            axh, axl = ph, plo
        else:
            axh, axl = dw_add(axh, axl, ph, plo)
    return dw_add(bh, bl, -axh, -axl)


def k5_step_cost(P: int):
    """K5's cost model for :func:`poms_tpu_torch.ops.kron.kron_tiling`: one
    block an SM, a plane step costing its warps' contractions (the axis-2
    pass over T1 + 2P rows, the two others over T1) and the window load."""
    def cost(T1, T2, threads, chunk, blocks, sms):
        rows = T1 + 2 * P
        step = (threads / 32 * (3.0 * rows / T1 + 5.0)
                + rows * (T2 + 2 * P) / 64.0)
        return math.ceil(blocks / sms) * (chunk + 2 * P + 2) * step

    return cost


def build_kron_df_plan(terms_df, npts, pads, periodic=None,
                       labels=None) -> KronPlan:
    """K5's launch data, once per operator: K1's plan of the hi bands (the
    lifted geometry, the sharing plan) with the lo bands stacked beside them
    and a tiling for K5's block size."""
    periodic = (False,) * len(npts) if periodic is None else periodic
    hi = [[B[0] for B in term] for term in terms_df]
    lo = [[B[1] for B in term] for term in terms_df]
    plan = build_kron_plan(hi, npts, pads, periodic, labels=labels,
                           threads_max=MAX_THREADS_DW, tcols=1,
                           cost=k5_step_cost(max(max(pads), 1)))
    plan.bands_lo = stack_bands(lo, plan.labels, plan.n3, plan.pads3, plan.P,
                                centre=0.0)
    return plan


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("kron_apply_dw")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kron_residual_dw.argtypes = [ptr] * 15
    lib.kron_residual_dw.restype = i32
    lib.kron_dw_eft_test.argtypes = [ptr] * 5 + [i32, ptr]
    lib.kron_dw_eft_test.restype = i32
    lib.kron_apply_dw_error_string.argtypes = [i32]
    lib.kron_apply_dw_error_string.restype = ctypes.c_char_p
    return lib


def _raise_if(err: int, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            + _library().kron_apply_dw_error_string(err).decode())


def _df_c_args(plan: KronPlan):
    """ctypes int arrays of the geometry and the whole operator's sharing
    plan in the kernel's layout (kept on the plan)."""
    if not plan._cargs:
        sp = sharing_plan(plan.labels)

        def padded(xs, n):
            return list(xs) + [0] * (n - len(xs))

        counts = [len(sp["u_lab"]), len(sp["v_src"]), len(sp["w_src"]),
                  len(sp["term_w"])]
        caps = [CAPS_DW[k] for k in "uvwt"]
        if any(n > c for n, c in zip(counts, caps)) \
                or plan.P not in COMPILED_P_DW:
            raise RuntimeError(
                f"the double-word Kronecker kernel holds at most {CAPS_DW} "
                f"partials/terms at half-widths {COMPILED_P_DW}; this "
                f"operator needs {counts} at half-width {plan.P}")
        ints = (counts + padded(sp["u_lab"], caps[0])
                + padded(sp["v_src"], caps[1]) + padded(sp["v_lab"], caps[1])
                + padded(sp["w_src"], caps[2]) + padded(sp["w_lab"], caps[2])
                + padded(sp["term_w"], caps[3]))
        T1, T2, chunk = plan.tiling
        geo = [*plan.n3, *(int(q) for q in plan.per3), plan.P, T1, T2, chunk,
               32 * math.ceil(T1 * T2 / 32), plan.n_terms]
        plan._cargs = [(ctypes.c_int * len(geo))(*geo),
                       (ctypes.c_int * len(ints))(*ints)]
    return plan._cargs


def residual_kron_df(terms_df: Sequence[Sequence[Tuple]], bh, bl, xh, xl,
                     pads, labels=None, periodic=None,
                     plan: Optional[KronPlan] = None):
    """r = b − (Σ_r ⊗_a B_r^(a))·x in double-word f32.

    ``terms_df``: per term, per axis, (band_hi, band_lo) f32 pairs.  The
    partial products are shared along ``labels`` (default: identity of the
    hi bands), as in the plain Kronecker apply.  ``xl=None`` and
    ``bh=bl=None`` stand for fields of zeros and give the bits that explicit
    zeros give.  CPU tensors take the plain version; CUDA tensors launch K5
    or raise.  ``plan`` (:func:`build_kron_df_plan`, once per operator)
    spares building the launch data per call.
    """
    if (bh is None) != (bl is None):
        raise ValueError("bh and bl are given or omitted together")
    if xh.device.type == "cpu":
        zero = (torch.zeros_like(xh) if xl is None or bh is None else None)
        return residual_kron_df_plain(
            terms_df, zero if bh is None else bh, zero if bl is None else bl,
            xh, zero if xl is None else xl, pads, labels, periodic)
    if xh.device.type != "cuda":
        raise NotImplementedError(
            f"residual_kron_df on {xh.device.type} tensors")
    if plan is None:
        plan = build_kron_df_plan(terms_df, xh.shape, pads, periodic, labels)
    with torch.cuda.device(xh.device):
        return _launch_df(plan, bh, bl, xh, xl,
                          torch.cuda.current_stream().cuda_stream)


def _launch_df(plan: KronPlan, bh, bl, xh, xl, stream):
    """Check the operands, allocate the result and launch K5 on ``stream``."""
    fields = [("xh", xh), ("xl", xl), ("bh", bh), ("bl", bl)]
    for name, t in fields:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the double-word kernel takes float32 pairs, "
                            f"got {name} of {t.dtype}")
        if tuple(t.shape) != plan.npts or t.device != plan.device:
            raise ValueError(f"{name} has shape {tuple(t.shape)} on "
                             f"{t.device}, expected {plan.npts} on "
                             f"{plan.device}")
    xh, xl, bh, bl = (None if t is None else t.contiguous()
                      for _, t in fields)
    geo, ints = _df_c_args(plan)
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _library().kron_residual_dw(
        ptr(xh), ptr(xl), ptr(bh), ptr(bl),
        *(ptr(t) for pair in zip(plan.bands, plan.bands_lo) for t in pair),
        ptr(rh), ptr(rl), geo, ints, stream)
    _raise_if(err, "residual_kron_df")
    residual_kron_df.launches += 1
    return rh, rl


residual_kron_df.launches = 0


def eft_on_card(ah, al, bh, bl):
    """The kernel's own error-free transformations on f32 CUDA vectors:
    an (8, n) tensor of two_sum(ah, bh), two_prod(ah, bh), dw_mul(a, b) and
    dw_add(a, b), (hi, lo) each: the test entry of ``kron_apply_dw.cu``."""
    if ah.device.type != "cuda":
        raise NotImplementedError("eft_on_card runs the CUDA kernel's EFTs")
    ops = [t.contiguous() for t in (ah, al, bh, bl)]
    out = torch.empty((8, ah.numel()), dtype=torch.float32, device=ah.device)
    with torch.cuda.device(ah.device):
        err = _library().kron_dw_eft_test(
            *(t.data_ptr() for t in ops), out.data_ptr(), ah.numel(),
            torch.cuda.current_stream().cuda_stream)
    _raise_if(err, "eft_on_card")
    return out


def _dw_sum_tree_last(sh, sl):
    """Pairwise-tree sum along the last axis of (…, n) dw arrays → (…,) f64.

    Each step adds the first half to the second half (the JAX package's
    pairing, so both sum in the same order)."""
    while sh.shape[-1] > 1:
        m = sh.shape[-1]
        half = (m + 1) // 2
        pad = half * 2 - m
        if pad:
            sh = F.pad(sh, (0, pad))
            sl = F.pad(sl, (0, pad))
        sh, sl = dw_add(sh[..., :half], sl[..., :half],
                        sh[..., half:], sl[..., half:])
    return sh[..., 0].to(torch.float64) + sl[..., 0].to(torch.float64)


def dw_sum_tree(sh, sl):
    """Flat double-word pairwise-tree sum → one f64 scalar."""
    return _dw_sum_tree_last(sh.reshape(-1), sl.reshape(-1))


def dw_dot_stack(pairs):
    """k double-word dots in one batched tree → (k,) f64.

    ``pairs``: sequence of (xh, xl, yh, yl) same-shape arrays."""
    ph, pl = [], []
    for xh, xl, yh, yl in pairs:
        h, lo = dw_mul(xh.reshape(-1), xl.reshape(-1),
                       yh.reshape(-1), yl.reshape(-1))
        ph.append(h)
        pl.append(lo)
    return _dw_sum_tree_last(torch.stack(ph), torch.stack(pl))


def dw_dot(xh, xl, yh, yl):
    """⟨x, y⟩ of two double-word arrays as one f64 scalar."""
    sh, sl = dw_mul(xh.reshape(-1), xl.reshape(-1),
                    yh.reshape(-1), yl.reshape(-1))
    return dw_sum_tree(sh, sl)


def dw_norm2(xh, xl):
    """‖x‖₂ of a double-word array, accumulated in double-word."""
    fh = xh.reshape(-1)
    fl = xl.reshape(-1)
    sh, sl = dw_mul(fh, fl, fh, fl)
    return torch.sqrt(dw_sum_tree(sh, sl))
