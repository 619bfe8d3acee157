"""Double-word f32 ("dw") arithmetic for residuals below the f32 floor.

Counterpart of ``poms_tpu.ops.twofloat``: error-free transformations
(Knuth two_sum, an exact two_prod) and double-word add/mul (Joldes, Muller &
Popescu, ACM TOMS 2017) on f32 pairs (hi, lo) whose sum carries ~49
mantissa bits, plus the double-word Kronecker residual and the dots and
norms of the dw-PCG recurrences.

Eager PyTorch runs each elementwise operation as its own kernel, so no
multiply is contracted with an add into an FMA across these lines.  The
toolbox keeps the JAX package's contraction-immune form anyway (every
product in two_prod is exact), so a fused kernel of it stays exact.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.ops.kron import band_labels

__all__ = ["split_f64", "merge_f64", "two_sum", "two_prod", "dw_add",
           "dw_mul", "dw_mul_fd", "dw_neg", "residual_kron_df", "dw_norm2",
           "dw_dot", "dw_sum_tree", "dw_dot_stack"]

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


def residual_kron_df(terms_df: Sequence[Sequence[Tuple]], bh, bl, xh, xl,
                     pads, labels=None, periodic=None):
    """r = b − (Σ_r ⊗_a B_r^(a))·x in double-word f32.

    ``terms_df``: per term, per axis, (band_hi, band_lo) f32 pairs.  The
    partial products are shared along ``labels`` (default: identity of the
    hi bands), as in the plain Kronecker apply.
    """
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
