"""Double-word f32 ("dw") arithmetic for residuals below the f32 floor.

Counterpart of ``poms_tpu.ops.twofloat``: error-free transformations
(Knuth two_sum, an exact two_prod) and double-word add/mul (Joldes, Muller &
Popescu, ACM TOMS 2017) on f32 pairs (hi, lo) whose sum carries ~49
mantissa bits, plus the double-word Kronecker residual and the dots and
norms of the dw-PCG recurrences.

Eager PyTorch runs each elementwise operation as its own kernel, so no
multiply is contracted with an add into an FMA across these lines.
two_prod takes its pair from the exact f64 product: the FMA's pair, which
the kernels compute.

K5: for CUDA tensors :func:`residual_kron_df` launches the hand-written
kernel of ``csrc/kron_apply_dw.cu`` (or raises): K5 at the compiled
half-widths 1-8, K5r (the half-width taken at run time) above them; for
CPU tensors it runs :func:`residual_kron_df_plain`.  The kernel performs
the plain version's operations in its order with adds and multiplies the
compiler may not fuse, so its words equal the plain version's.  An operator with more partials or
terms than one launch holds (``CAPS_DW``) takes several launches, chained
through the double-word sum of the terms done so far.
``residual_kron_df.launches`` counts kernel launches,
``residual_kron_df.runtime.launches`` those of K5r among them.

K6: the dots and norms (:func:`dw_dot_stack`, :func:`dw_dot`,
:func:`dw_norm2`, :func:`dw_sum_tree`) launch ``csrc/dw_reduce.cu`` for CUDA
tensors (K6r: every field read once, a fixed order of double-word
additions, the f64 result left on the device) and take the pairwise tree of
the ``*_plain`` functions for CPU tensors; the two orders agree to the
accuracy of double-word addition, not bitwise.  The elementwise recurrences
of the solvers (:func:`dw_update`) launch ``csrc/dw_update.cu`` (K6u), whose
words equal :func:`dw_update_plain`'s.  A ``None`` low word is a field of
zeros and is never read on the card.  ``dw_dot_stack.launches`` and
``dw_update.launches`` count kernel launches: one a K6r call of up to
``MAX_DOTS`` dots, whose last block adds every block's partial pair (the
partials and the arrival counter live in :func:`reduce_scratch`'s
per-device buffers).
"""
from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.ops import _build
from poms_tpu_torch.ops.kron import (STAGES, KronPlan, _compiled_half_width,
                                     _lift_labels, band_labels,
                                     build_kron_plan, chunk_terms,
                                     refuse_half_width, sharing_plan,
                                     stack_bands)
from poms_tpu_torch.ops.stencil import K2_SMEM

__all__ = ["split_f64", "merge_f64", "two_sum", "two_prod", "dw_add",
           "dw_mul", "dw_mul_fd", "dw_neg", "residual_kron_df",
           "residual_kron_df_plain", "build_kron_df_plan",
           "COMPILED_P_DW", "k5_step_cost", "k5_smem_bytes", "k5r_smem",
           "k5_resources",
           "eft_on_card",
           "dw_norm2", "dw_dot", "dw_sum_tree", "dw_dot_stack",
           "dw_norm2_plain", "dw_dot_plain", "dw_sum_tree_plain",
           "reduce_scratch",
           "dw_dot_stack_plain", "dw_update", "dw_update_plain",
           "UPDATE_MODES"]

# mirrored in csrc/kron_apply_dw.cu (kCU, kCV, kCW, kCT, kMaxThreads,
# kRegisterP, kron::kStages and the instantiated half-widths): what one
# launch holds, and the widest half-width of the register ring; wider bands
# than the compiled ones run on K5r at their own half-width
CAPS_DW = {"u": 2, "v": 3, "w": 4, "t": 4}
COMPILED_P_DW = (1, 2, 3, 4, 5, 6, 7, 8)
MAX_THREADS_DW = 256
REGISTER_P_DW = 5


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


def two_prod(a, b):
    """p + e == a·b exactly: p = f32(a·b) rounded from the exact f64
    product of two f32 values, e = f32(a·b − p) (exact unless it
    underflows), the pair an FMA gives (``csrc/dw_eft.cuh``).  The JAX
    package's form sums the four partial products of 12|12-bit splits by a
    two_sum cascade, whose error sum rounds in rare cases (6.4295678 ×
    −0.0012753165: its e is 5.6e-17 off); elsewhere in the normal range the
    two agree."""
    ex = a.to(torch.float64) * b.to(torch.float64)
    p = ex.to(torch.float32)
    return p, (ex - p.to(torch.float64)).to(torch.float32)


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
                           xl, pads, labels=None, periodic=None,
                           negate: bool = False):
    """Plain PyTorch K5: r = b − (Σ_r ⊗_a B_r^(a))·x in double-word f32,
    axis passes right to left, partials shared along ``labels``, taps and
    terms added in order; ``negate`` returns −r, word by word."""
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
    rh, rl = dw_add(bh, bl, -axh, -axl)
    return dw_neg(rh, rl) if negate else (rh, rl)


def k5_smem_bytes(P: int, histories: int, T1: int, T2: int,
                  chunk: int, runtime: bool = False) -> int:
    """Shared memory of a K5 block (``kron_apply_dw.cu::smem_bytes``, and
    ``smem_bytes_wide`` above ``REGISTER_P_DW`` and for K5r, ``runtime``);
    ``histories``: the instantiation's (3 or 4)."""
    WR, WC, W = T1 + 2 * P, T2 + 2 * P, 2 * P + 1
    words = (STAGES * WR * WC + CAPS_DW["u"] * WR * T2
             + histories * chunk * W)
    if runtime or P > REGISTER_P_DW:
        words += (CAPS_DW["u"] * W * T2 + CAPS_DW["v"] * W * T1
                  + histories * W * T1 * T2)
    return 8 * WR * WC + 2 * 4 * words


def k5r_smem(histories: int):
    """K5r's shared memory, ``smem(P, T1, T2, chunk)`` in bytes, for the
    instantiation of ``histories`` (3 or 4): the wide layout."""
    return lambda P, T1, T2, chunk: k5_smem_bytes(P, histories, T1, T2,
                                                  chunk, runtime=True)


def k5_step_cost(P: int, histories: int = 3, runtime: bool = False):
    """K5's cost model for :func:`poms_tpu_torch.ops.kron.kron_tiling`: one
    block an SM, a plane step costing its warps' contractions (the axis-2
    pass over T1 + 2P rows, the two others over T1) and the window load;
    infinite for a block whose shared memory exceeds the card's limit
    (``runtime``: K5r's layout)."""
    def cost(T1, T2, threads, chunk, blocks, sms):
        if k5_smem_bytes(P, histories, T1, T2, chunk, runtime) > K2_SMEM:
            return math.inf
        rows = T1 + 2 * P
        step = (threads / 32 * (3.0 * rows / T1 + 5.0)
                + rows * (T2 + 2 * P) / 64.0)
        return math.ceil(blocks / sms) * (chunk + 2 * P + 2) * step

    return cost


def build_kron_df_plan(terms_df, npts, pads, periodic=None,
                       labels=None, half_widths=COMPILED_P_DW) -> KronPlan:
    """K5's launch data, once per operator: K1's plan of the hi bands (the
    lifted geometry, the sharing plan cut into runs of terms that one K5
    launch holds) with the lo bands stacked beside them and a tiling for
    K5's block size and shared memory.  Bands wider than every one of
    ``half_widths`` (default: the compiled ones) take K5r at their own
    half-width; on the card a half-width no block of K5r fits raises."""
    periodic = (False,) * len(npts) if periodic is None else periodic
    hi = [[B[0] for B in term] for term in terms_df]
    lo = [[B[1] for B in term] for term in terms_df]
    lab3 = _lift_labels(band_labels(hi) if labels is None else labels)
    histories = 3 if max(len(sharing_plan(lab3, run)["w_src"])
                         for run in chunk_terms(lab3, CAPS_DW)) <= 3 else 4
    P = _compiled_half_width(pads, half_widths)
    runtime = P not in half_widths
    plan = build_kron_plan(hi, npts, pads, periodic, labels=labels,
                           threads_max=MAX_THREADS_DW, tcols=1,
                           cost=k5_step_cost(P, histories, runtime),
                           caps=CAPS_DW, half_widths=half_widths,
                           smem=k5r_smem(histories),
                           what=f"K5r ({histories} histories)")
    plan.bands_lo = stack_bands(lo, plan.labels, plan.n3, plan.pads3, plan.P,
                                centre=0.0)
    return plan


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("kron_apply_dw")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in ("kron_residual_dw", "kron_residual_dw_rt"):
        getattr(lib, fn).argtypes = [ptr] * 16 + [i32, i32, ptr]
        getattr(lib, fn).restype = i32
    lib.kron_residual_dw_resources.argtypes = [ptr] * 3 + [i32]
    lib.kron_residual_dw_resources.restype = i32
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
    """ctypes int arrays of the geometry and of each run's sharing plan in
    the kernel's layout (kept on the plan): ``[geo, run_0, run_1, ...]``."""
    if not plan._cargs:
        def padded(xs, n):
            return list(xs) + [0] * (n - len(xs))

        caps = [CAPS_DW[k] for k in "uvwt"]
        runs = []
        for sp in plan.plans:
            counts = [len(sp["u_lab"]), len(sp["v_src"]), len(sp["w_src"]),
                      len(sp["term_w"])]
            ints = (counts + padded(sp["u_lab"], caps[0])
                    + padded(sp["v_src"], caps[1])
                    + padded(sp["v_lab"], caps[1])
                    + padded(sp["w_src"], caps[2])
                    + padded(sp["w_lab"], caps[2])
                    + padded(sp["term_w"], caps[3]))
            runs.append((ctypes.c_int * len(ints))(*ints))
        T1, T2, chunk = plan.tiling
        geo = [*plan.n3, *(int(q) for q in plan.per3), plan.P, T1, T2, chunk,
               32 * math.ceil(T1 * T2 / 32), plan.n_terms]
        plan._cargs = [(ctypes.c_int * len(geo))(*geo)] + runs
    return plan._cargs


def residual_kron_df(terms_df: Sequence[Sequence[Tuple]], bh, bl, xh, xl,
                     pads, labels=None, periodic=None,
                     plan: Optional[KronPlan] = None, negate: bool = False):
    """r = b − (Σ_r ⊗_a B_r^(a))·x in double-word f32 (``negate``: −r, so
    that b = 0 gives A·x with its own sign).

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
            xh, zero if xl is None else xl, pads, labels, periodic, negate)
    if xh.device.type != "cuda":
        raise NotImplementedError(
            f"residual_kron_df on {xh.device.type} tensors")
    if plan is None:
        plan = build_kron_df_plan(terms_df, xh.shape, pads, periodic, labels)
    with torch.cuda.device(xh.device):
        return _launch_df(plan, bh, bl, xh, xl, negate,
                          torch.cuda.current_stream().cuda_stream)


def _launch_df(plan: KronPlan, bh, bl, xh, xl, negate, stream):
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
    geo, *runs = _df_c_args(plan)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    bands = [ptr(t) for pair in zip(plan.bands, plan.bands_lo) for t in pair]
    lib = _library()
    fn = lib.kron_residual_dw_rt if plan.runtime else lib.kron_residual_dw
    acc = (None, None)
    for k, run in enumerate(runs):
        # every run but the last writes the sum of the terms so far
        last = k == len(runs) - 1
        rh, rl = torch.empty_like(xh), torch.empty_like(xh)
        err = fn(ptr(xh), ptr(xl), ptr(bh) if last else None,
                 ptr(bl) if last else None, *map(ptr, acc), *bands, ptr(rh),
                 ptr(rl), geo, run, int(bool(negate)), int(last), stream)
        _raise_if(err, "residual_kron_df")
        residual_kron_df.launches += 1
        if plan.runtime:
            residual_kron_df.runtime.launches += 1
        acc = (rh, rl)
    return rh, rl


residual_kron_df.launches = 0
residual_kron_df.runtime = SimpleNamespace(launches=0)   # K5r's among them


def k5_resources(plan: KronPlan) -> dict:
    """What K5's (or K5r's) first launch of ``plan`` gets on the card:
    registers and local memory (spilled registers) a thread, shared memory
    a block, blocks an SM holds at once, threads a block."""
    geo, ints = _df_c_args(plan)[:2]
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(plan.device):
        _raise_if(_library().kron_residual_dw_resources(
            geo, ints, out, int(plan.runtime)), "k5_resources")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3], "threads": geo[10]}


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


def _flat(hi, lo):
    """A flattened pair, a ``None`` low word as zeros."""
    hi = hi.reshape(-1)
    return hi, torch.zeros_like(hi) if lo is None else lo.reshape(-1)


def dw_sum_tree_plain(sh, sl):
    """Plain K6r: flat double-word pairwise-tree sum → one f64 scalar."""
    return _dw_sum_tree_last(*_flat(sh, sl))


def dw_dot_stack_plain(pairs):
    """Plain K6r: k double-word dots in one batched tree → (k,) f64."""
    ph, pl = [], []
    for xh, xl, yh, yl in pairs:
        h, lo = dw_mul(*_flat(xh, xl), *_flat(yh, yl))
        ph.append(h)
        pl.append(lo)
    return _dw_sum_tree_last(torch.stack(ph), torch.stack(pl))


def dw_dot_plain(xh, xl, yh, yl):
    """Plain K6r: ⟨x, y⟩ of two double-word arrays as one f64 scalar."""
    return dw_sum_tree_plain(*dw_mul(*_flat(xh, xl), *_flat(yh, yl)))


def dw_norm2_plain(xh, xl):
    """Plain K6r: ‖x‖₂ of a double-word array."""
    return torch.sqrt(dw_dot_plain(xh, xl, xh, xl))


MAX_DOTS = 4          # kMaxDots of csrc/dw_reduce.cu
REDUCE_MAX_BLOCKS = 264   # kMaxBlocks of csrc/dw_reduce.cu


@functools.cache
def _reduce_library() -> ctypes.CDLL:
    lib = _build.load("dw_reduce")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_reduce.argtypes = [ptr, i32, i64, ptr, i64, ptr, ptr, i32, ptr]
    lib.dw_reduce.restype = i32
    lib.dw_reduce_max_blocks.argtypes = []
    lib.dw_reduce_max_blocks.restype = i32
    lib.dw_reduce_error_string.argtypes = [i32]
    lib.dw_reduce_error_string.restype = ctypes.c_char_p
    if lib.dw_reduce_max_blocks() != REDUCE_MAX_BLOCKS:
        raise RuntimeError("csrc/dw_reduce.cu's kMaxBlocks is not "
                           "REDUCE_MAX_BLOCKS")
    return lib


@functools.cache
def reduce_scratch(device: torch.device):
    """K6r's per-device buffers, made (and zeroed) once and reused by every
    call on the device, graph replays included: the blocks' partial pairs
    (2·MAX_DOTS·REDUCE_MAX_BLOCKS f32) and the arrival counter (one int32,
    0 between calls: the kernel's last block resets it).

    One set per device, not per stream: two K6r calls on one device must
    not run at the same time (on two streams, or in two graphs replayed
    concurrently), or their partials mix and the counter is left non-zero
    for every later call.  The solvers and benches run their reductions
    on one stream, or on streams ordered one after the other."""
    part = torch.empty(2 * MAX_DOTS * REDUCE_MAX_BLOCKS, dtype=torch.float32,
                       device=device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    return part, counter


def _flat_f32(name, t, like=None):
    """A contiguous flat f32 view of an operand (``None`` stays None)."""
    if t is None:
        return None
    if t.dtype != torch.float32:
        raise TypeError(f"the double-word kernels take float32 words, got "
                        f"{name} of {t.dtype}")
    if like is not None and (t.numel() != like.numel()
                             or t.device != like.device):
        raise ValueError(f"{name} has {t.numel()} values on {t.device}, "
                         f"expected {like.numel()} on {like.device}")
    return t.contiguous().reshape(-1)


def _launch_reduce(pairs, sqrt: bool) -> torch.Tensor:
    """K6r on up to MAX_DOTS (xh, xl, yh, yl) tuples → (k,) f64, one
    launch."""
    first = pairs[0][0]
    lib = _reduce_library()
    keep, ptrs = [], []
    for xh, xl, yh, yl in pairs:
        if yh is None and yl is not None:
            raise ValueError("a low word needs its high word")
        ops = [_flat_f32(n, t, first)
               for n, t in zip(("xh", "xl", "yh", "yl"), (xh, xl, yh, yl))]
        keep.append(ops)
        ptrs += [None if t is None else t.data_ptr() for t in ops]
    k = len(pairs)
    part, counter = reduce_scratch(first.device)
    out = torch.empty(k, dtype=torch.float64, device=first.device)
    with torch.cuda.device(first.device):
        err = lib.dw_reduce((ctypes.c_void_p * len(ptrs))(*ptrs), k,
                            first.numel(), part.data_ptr(), part.numel(),
                            counter.data_ptr(), out.data_ptr(), int(sqrt),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("dw_reduce kernel launch failed: "
                           + lib.dw_reduce_error_string(err).decode())
    dw_dot_stack.launches += 1
    return out


def _reduce(pairs, plain, sqrt=False):
    """Dispatch on the first operand's device: plain tree or K6r."""
    first = pairs[0][0]
    if first.device.type == "cpu":
        return plain()
    if first.device.type != "cuda":
        raise NotImplementedError(
            f"double-word reductions on {first.device.type} tensors")
    outs = [_launch_reduce(pairs[i:i + MAX_DOTS], sqrt)
            for i in range(0, len(pairs), MAX_DOTS)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def dw_dot_stack(pairs):
    """k double-word dots in one pass → (k,) f64 on the operands' device.

    ``pairs``: sequence of (xh, xl, yh, yl) same-shape arrays; a low word
    may be ``None`` (zeros)."""
    pairs = list(pairs)
    return _reduce(pairs, lambda: dw_dot_stack_plain(pairs))


dw_dot_stack.launches = 0


def dw_sum_tree(sh, sl):
    """Double-word sum of a (hi, lo) array → one f64 scalar."""
    return _reduce([(sh, sl, None, None)],
                   lambda: dw_sum_tree_plain(sh, sl)).reshape(())


def dw_dot(xh, xl, yh, yl):
    """⟨x, y⟩ of two double-word arrays as one f64 scalar."""
    return _reduce([(xh, xl, yh, yl)],
                   lambda: dw_dot_plain(xh, xl, yh, yl)).reshape(())


def dw_norm2(xh, xl):
    """‖x‖₂ of a double-word array, accumulated in double-word, the square
    root taken in f64 on the device."""
    return _reduce([(xh, xl, xh, xl)], lambda: dw_norm2_plain(xh, xl),
                   sqrt=True).reshape(())


# -- K6u: the solvers' elementwise recurrences --------------------------------

# mode → (fields read, device scalars read, fields written); the order of
# csrc/dw_update.cu's enum
UPDATE_MODES = {"cg": (7, 2, 6), "direction": (2, 2, 1), "defect": (3, 1, 2),
                "dwrr": (5, 2, 4), "div": (1, 1, 1), "mul": (1, 1, 1)}


def _safe32(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, scale,
                       torch.ones_like(scale)).to(torch.float32)


def dw_update_plain(mode: str, *ops):
    """Plain PyTorch K6u (see :func:`dw_update` for the operands)."""
    if mode == "cg":
        xh, xl, rh, rl, p, aph, apl, rz, pAp = ops
        a_h, a_l = split_f64(rz / pAp)
        xh, xl = dw_add(xh, xl, *dw_mul(a_h, a_l, p, torch.zeros_like(p)))
        drh, drl = dw_mul(-a_h, -a_l, aph, apl)
        rh, rl = dw_add(rh, rl, drh, drl)
        return xh, xl, rh, rl, drh, drl
    if mode == "direction":
        z, p, s, rz = ops
        return z + (s / rz).to(torch.float32) * p
    if mode == "defect":
        xh, xl, e, rn = ops
        return dw_add(xh, xl, *two_prod(e, _safe32(rn)))
    if mode == "dwrr":
        xh, xl, p, ap, rf, rz, pAp = ops
        a_h, a_l = split_f64(rz / pAp)
        xh, xl = dw_add(xh, xl, *dw_mul(a_h, a_l, p, torch.zeros_like(p)))
        if ap is None:
            return xh, xl
        dr = -a_h * ap
        return xh, xl, dr, rf + dr
    if mode == "div":
        x, s = ops
        return x / _safe32(s)
    if mode == "mul":
        x, s = ops
        return x * _safe32(s)
    raise ValueError(f"unknown dw_update mode {mode!r}")


@functools.cache
def _update_library() -> ctypes.CDLL:
    lib = _build.load("dw_update")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_update.argtypes = [i32, ptr, ptr, ptr, ptr, i64, ptr]
    lib.dw_update.restype = i32
    lib.dw_update_error_string.argtypes = [i32]
    lib.dw_update_error_string.restype = ctypes.c_char_p
    return lib


def dw_update(mode: str, *ops):
    """One elementwise recurrence of the double-word solvers in one pass,
    its scalars 0-dim f64 tensors on the fields' device (never read by the
    host).  With safe(s) = s if s > 0 else 1:

    - ``"cg"`` (xh, xl, rh, rl, p, aph, apl, rz, pAp): α = rz/pAp split
      into a pair; x += αp, dr = −α·Ap, r += dr in double-word →
      (xh, xl, rh, rl, drh, drl);
    - ``"direction"`` (z, p, s, rz) → z + f32(s/rz)·p;
    - ``"defect"`` (xh, xl, e, rn) → x + two_prod(e, f32(safe(rn)));
    - ``"dwrr"`` (xh, xl, p, ap, rf, rz, pAp): x += αp in double-word and,
      unless ``ap`` and ``rf`` are None, dr = −f32(α)·ap, rf += dr →
      (xh, xl, dr, rf) or (xh, xl);
    - ``"div"`` / ``"mul"`` (x, s) → x / f32(safe(s)), x · f32(safe(s)).

    CPU tensors take :func:`dw_update_plain`; CUDA tensors launch K6u or
    raise."""
    if mode not in UPDATE_MODES:
        raise ValueError(f"unknown dw_update mode {mode!r}")
    n_in, n_s, n_out = UPDATE_MODES[mode]
    if len(ops) != n_in + n_s:
        raise ValueError(f"dw_update({mode!r}) takes {n_in} fields and "
                         f"{n_s} scalars, got {len(ops)} operands")
    first = ops[0]
    if first.device.type == "cpu":
        return dw_update_plain(mode, *ops)
    if first.device.type != "cuda":
        raise NotImplementedError(
            f"dw_update on {first.device.type} tensors")
    fields, scalars = ops[:n_in], ops[n_in:]
    if mode == "dwrr":
        if (fields[3] is None) != (fields[4] is None):
            raise ValueError("ap and rf are given or omitted together")
        if fields[3] is None:
            n_out = 2
    elif any(t is None for t in fields):
        raise ValueError(f"dw_update({mode!r}) needs every field")
    flat = [_flat_f32(f"field {j}", t, first) for j, t in enumerate(fields)]
    for s in scalars:
        if s.dtype != torch.float64 or s.numel() != 1 \
                or s.device != first.device:
            raise TypeError("the scalars are 0-dim float64 tensors on the "
                            "fields' device")
    outs = [torch.empty(first.shape, dtype=torch.float32,
                        device=first.device) for _ in range(n_out)]
    ptr = ctypes.c_void_p
    ins = [None if t is None else t.data_ptr() for t in flat] \
        + [None] * (7 - len(flat))
    dst = [t.data_ptr() for t in outs] + [None] * (6 - n_out)
    lib = _update_library()
    with torch.cuda.device(first.device):
        err = lib.dw_update(
            list(UPDATE_MODES).index(mode), (ptr * 7)(*ins),
            scalars[0].data_ptr(),
            scalars[1].data_ptr() if n_s > 1 else None, (ptr * 6)(*dst),
            first.numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw_update kernel launch failed ({mode}): "
                           + lib.dw_update_error_string(err).decode())
    dw_update.launches += 1
    return outs[0] if n_out == 1 else tuple(outs)


dw_update.launches = 0
