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
kernel of ``csrc/kron_apply_dw.cu`` (or raises), picked by the half-width
alone, as K1's (``ops/kron.py::COMPILED_P``): K5, compiled at half-widths
1-3, or K5r (the half-width taken at run time, three one-axis passes
through a scratch buffer of the plan: :func:`k5r_launch_pass`, each pass's
plain version :func:`k5r_pass_plain`) at every wider one; for CPU tensors
it runs :func:`residual_kron_df_plain`.
The kernels perform the plain version's operations in its order with adds
and multiplies the compiler may not fuse, so their words equal the plain
version's.  An operator with more partials or terms than one launch holds
(``CAPS_DW``) takes several runs, chained through the double-word sum of
the terms done so far.  ``residual_kron_df.launches`` counts kernel
launches, ``residual_kron_df.runtime.launches[pass]`` those of each K5r
pass among them.

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
from poms_tpu_torch.ops import _count
from poms_tpu_torch.ops.kron import (COMPILED_P, LANES, RT_PASSES, SM_SMEM,
                                     STAGES, KronPlan, _compiled_half_width,
                                     _lift_labels, _pass_blocks, band_labels,
                                     build_kron_plan, chunk_terms,
                                     column_table, refuse_half_width,
                                     sharing_plan, stack_bands)
from poms_tpu_torch.ops.stencil import K2_SMEM
from poms_tpu_torch.utils.trace import span

__all__ = ["split_f64", "merge_f64", "two_sum", "two_prod", "dw_add",
           "dw_mul", "dw_mul_fd", "dw_neg", "residual_kron_df",
           "residual_kron_df_plain", "build_kron_df_plan", "k5_step_cost",
           "k5_smem_bytes", "k5r_smem",
           "k5r_pass_smem", "k5_resources", "k5r_launch_pass",
           "k5r_scratch_fields", "k5r_pass_plain", "k5r_passes_plain",
           "eft_on_card",
           "dw_norm2", "dw_dot", "dw_sum_tree", "dw_dot_stack",
           "dw_norm2_plain", "dw_dot_plain", "dw_sum_tree_plain",
           "reduce_scratch",
           "dw_dot_stack_plain", "dw_update", "dw_update_plain",
           "UPDATE_MODES"]

# mirrored in csrc/kron_apply_dw.cu (kCU, kCV, kCW, kCT, kMaxThreads and
# kron::kStages): what one launch holds
CAPS_DW = {"u": 2, "v": 3, "w": 4, "t": 4}
MAX_THREADS_DW = 256
# the rows a thread of the compiled K5 may own (its register micro-tile;
# csrc/kron_apply_dw.cu::launch_p), among which the tile model chooses per
# grid with the tile (neither height spills at P = 3 with 3 or 4
# histories), the warps an SM holds at each height (its registers at P = 3:
# 166 and 196 at two rows, 122 and 128 at one, so one and two blocks of 256
# threads), and its cost model (k5_step_cost) per
# height, µs: fitted to the tilings within 50% of the fastest of their grid
# and height in a sweep of both heights at the cells' 513³ and 512³ (3 and
# 4 histories) and the headline's coarse levels 257³ to 9³ (3), on an H100
# (bench/k1_compare.py --sweep-k5)
K5_ROWS = (2, 1)
K5_WARPS = {2: 8, 1: 16}
K5_COST = {2: {"step": 2.782, "tap": 9.976e-5, "chain": 1.779e-2,
               "part": 0.191, "tail": 0.1008},
           1: {"step": 1.048, "tap": 1.556e-4, "chain": 2.485e-2,
               "part": 0.1501, "tail": 0.184}}


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
                  chunk: int, rows: int = 1) -> int:
    """Shared memory of a compiled K5 block (``kron_apply_dw.cu::K5Smem``)
    at ``rows`` rows a thread; ``histories``: the instantiation's (3 or 4).
    Each section 16-byte aligned: the ring of ``STAGES`` windows, the u
    partials of two planes, the axis-1 band table, the axis-0 band rows of
    the run (every value a (hi, lo) pair, 8 bytes) and the window's int64
    source offsets."""
    def up16(b):
        return -(-b // 16) * 16

    WR, WC, W = T1 + 2 * P, T2 + 2 * P, 2 * P + 1
    sizes = (8 * STAGES * WR * WC, 8 * 2 * CAPS_DW["u"] * WR * T2,
             8 * CAPS_DW["v"] * T1 * (rows + 2 * P),
             8 * histories * (chunk + 4 * P) * W, 8 * WR * WC)
    return sum(up16(s) for s in sizes)


RT_ROWS_A_DW = 2   # K5r's pass A: rows a thread (kRowsA of kron_apply_dw.cu)
RT_OUT_DW = 2      # K5r's passes B and C: outputs along the axis a thread


def k5r_pass_smem(P: int, pass_: str, warps: int) -> int:
    """Shared memory of one K5r pass's block in bytes
    (``csrc/kron_apply_dw.cu::smem_pass``): its staged tile (32 columns;
    pass A ``warps``·RT_ROWS_A_DW rows 32 + 2P wide, B and C the block's
    outputs and 2P halo rows per source) and its band rows, hi and lo."""
    W, L = 2 * P + 1, LANES
    if pass_ == "A":
        words = warps * RT_ROWS_A_DW * (L + 2 * P) + CAPS_DW["u"] * W * L
    else:
        rows = warps * RT_OUT_DW + 2 * P
        src, nb = ((CAPS_DW["u"], CAPS_DW["v"]) if pass_ == "B"
                   else (CAPS_DW["v"], CAPS_DW["w"]))
        words = src * rows * L + nb * warps * RT_OUT_DW * W
    return 2 * 4 * words


def k5r_smem(histories: int):
    """K5r's shared memory, ``smem(P, warps)`` in bytes: its largest pass
    at ``warps`` warps a block (:func:`k5r_pass_smem`; the same for 3 and
    4 ``histories``: pass C holds room for every history's band rows)."""
    del histories
    return lambda P, warps: max(k5r_pass_smem(P, p, warps)
                                for p in RT_PASSES)


def k5_step_cost(P: int, histories: int = 3, runtime: bool = False,
                 rows: int = 1):
    """K5's cost model for :func:`poms_tpu_torch.ops.kron.kron_tiling` at
    ``rows`` rows a thread, in µs, its constants ``K5_COST[rows]``: an SM
    holds as many blocks as its warps (``K5_WARPS[rows]``) and shared
    memory allow, and takes its share of the blocks, blocks ÷ SMs ÷ that
    (at least one block), a ``"part"`` of the last wave's idle room (a
    wave that is not whole still takes a block's time: on coarse grids,
    few waves) and ``"tail"`` more (blocks end unevenly); a block marches over its run's
    planes and 2P more, a step costing ``"step"`` (its barrier) plus the
    larger of the double-word taps of the SM's resident warps, ``"tap"``
    each (a thread's taps a step: the axis-1 pass for each v and the
    axis-0 pass for each history over its rows, the axis-2 pass over its
    share of the T1 + 2P window rows; idle lanes of a block's last warp
    count), and the taps of its slowest thread's chains, ``"chain"`` each
    (where few warps are resident their latency sets the pace).  Infinite
    for a block whose shared memory exceeds the card's limit.
    ``runtime``: K5r's model for
    :func:`poms_tpu_torch.ops.kron.runtime_tiling`,
    ``cost(n3, pass, warps, TL, sms)``: the work of all blocks (a block's
    staged words, band tables included, and its double-word taps, 29
    operations each at 8 a staged word), as if there were two blocks an SM
    where there are fewer; infinite for a block over the card's shared
    memory (``bench/k1_compare.py --sweep-rt`` measures the passes at
    each block size on the card)."""
    if runtime:
        W = 2 * P + 1
        chains = {"A": CAPS_DW["u"], "B": CAPS_DW["v"], "C": histories}
        src = {"A": 1, "B": CAPS_DW["u"], "C": CAPS_DW["v"]}
        bands = {"A": CAPS_DW["u"], "B": CAPS_DW["v"], "C": CAPS_DW["w"]}

        def rt_cost(n3, pass_, warps, TL, sms):
            need = k5r_pass_smem(P, pass_, warps)
            if need > K2_SMEM:
                return math.inf
            blocks, rows, cols = _pass_blocks(n3, pass_, warps, TL,
                                              RT_ROWS_A_DW, RT_OUT_DW, 1)
            table = 2 * bands[pass_] * W * (LANES if pass_ == "A" else rows)
            work = (2 * src[pass_] * (rows + 2 * P) * cols + table
                    + rows * cols * W * chains[pass_] * 29 / 8)
            return max(blocks, 2 * sms) * work

        return rt_cost

    k, W = K5_COST[rows], 2 * P + 1
    outs = rows * (CAPS_DW["v"] + histories)   # axis-1 and axis-0 chains

    def cost(T1, T2, threads, chunk, blocks, sms):
        smem = k5_smem_bytes(P, histories, T1, T2, chunk, rows)
        if smem > K2_SMEM:
            return math.inf
        per_sm = max(1, min(K5_WARPS[rows] * 32 // threads,
                            SM_SMEM // (smem + 1024)))
        resident = min(per_sm, max(1.0, blocks / sms))
        share = T1 + 2 * P, T1 // rows   # window rows over row groups
        taps = W * (outs + CAPS_DW["u"] * share[0] / share[1])
        chain = W * (outs + CAPS_DW["u"] * math.ceil(share[0] / share[1]))
        step = k["step"] + max(k["tap"] * resident * threads * taps,
                               k["chain"] * chain)
        fluid = blocks / (sms * per_sm)
        waves = (max(1.0, fluid + k["part"] * (math.ceil(fluid) - fluid))
                 + k["tail"])
        return waves * (chunk + 2 * P) * step

    return cost


def build_kron_df_plan(terms_df, npts, pads, periodic=None,
                       labels=None) -> KronPlan:
    """K5's launch data, once per operator: K1's plan of the hi bands (the
    lifted geometry, the sharing plan cut into runs of terms that one K5
    launch holds) with the lo bands stacked beside them and a tiling for
    K5's block size and shared memory; its terms are not folded (K1's
    ``build_kron_plan(fold=False)``: a folded band would have to be summed
    before the split into words); the compiled K5's rows a thread and tile
    come from its cost model among ``K5_ROWS``.  Bands
    wider than every one of ``COMPILED_P`` take K5r at their own
    half-width; on the card a half-width no block of K5r fits raises.  A K5r plan built on the card
    owns its passes' scratch: the hi and lo words of the kCU u and kCV v
    partials, 40 bytes a point (105 MB at 138³), reused by every launch of
    the plan."""
    periodic = (False,) * len(npts) if periodic is None else periodic
    hi = [[B[0] for B in term] for term in terms_df]
    lo = [[B[1] for B in term] for term in terms_df]
    lab3 = _lift_labels(band_labels(hi) if labels is None else labels)
    histories = 3 if max(len(sharing_plan(lab3, run)["w_src"])
                         for run in chunk_terms(lab3, CAPS_DW)) <= 3 else 4
    P = _compiled_half_width(pads)
    runtime = P not in COMPILED_P
    cost = (k5_step_cost(P, histories, runtime=True) if runtime
            else lambda R: k5_step_cost(P, histories, rows=R))
    plan = build_kron_plan(hi, npts, pads, periodic, labels=labels,
                           threads_max=MAX_THREADS_DW, tcols=1,
                           trows=None if runtime else K5_ROWS,
                           widths=(), cost=cost,
                           caps=CAPS_DW, smem=k5r_smem(histories),
                           what=f"K5r ({histories} histories)",
                           scratch_words=2 * (CAPS_DW["u"] + CAPS_DW["v"]),
                           k1r=False,
                           rt_cols=LANES, fold=False)
    plan.bands_lo = stack_bands(lo, plan.labels, plan.n3, plan.pads3, plan.P,
                                centre=0.0)
    if plan.scratch is not None:
        k5r_tables(plan)   # made here, before any graph captures a launch
    return plan


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("kron_apply_dw")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kron_residual_dw.argtypes = [ptr] * 16 + [i32, i32, ptr]
    lib.kron_residual_dw.restype = i32
    # K5r: the pass first, the scratch and the band table before the stream
    lib.kron_residual_dw_rt.argtypes = [i32] + [ptr] * 16 + [i32, i32, ptr,
                                                             ptr, ptr]
    lib.kron_residual_dw_rt.restype = i32
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
        if plan.runtime:   # K5r: (32, warps of passes A, B, C)
            geo = [*plan.n3, *(int(q) for q in plan.per3), plan.P,
                   plan.n_terms, *plan.tiling[1:]]
        else:
            T1, T2, chunk = plan.tiling
            geo = [*plan.n3, *(int(q) for q in plan.per3), plan.P, T1, T2,
                   chunk, 32 * math.ceil(T1 // plan.trows * T2 / 32),
                   plan.n_terms, plan.trows]
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
    if plan.runtime and plan.scratch is None:
        raise RuntimeError("this K5r plan was built off the card: it has no "
                           "scratch")
    acc = (None, None)
    for k, run in enumerate(runs):
        # every run but the last writes the sum of the terms so far
        last = k == len(runs) - 1
        rh, rl = torch.empty_like(xh), torch.empty_like(xh)
        args = (ptr(xh), ptr(xl), ptr(bh) if last else None,
                ptr(bl) if last else None, *map(ptr, acc), *bands, ptr(rh),
                ptr(rl), geo, run, int(bool(negate)), int(last))
        if plan.runtime:
            for pass_ in RT_PASSES:
                k5r_launch_pass(pass_, plan, args, stream, k)
        else:
            _raise_if(lib.kron_residual_dw(*args, stream),
                      "residual_kron_df")
            residual_kron_df.launches += 1
            _count.BYTES["k5.tiled_launches"] += plan.trows == 2
        acc = (rh, rl)
    return rh, rl


def _strided_table(hi, lo, labs, kmax: int, NW: int, P: int):
    """K5r's band table of a strided pass (B on axis 1, C on axis 0) of one
    run of terms, as each block's shared memory holds it: per block of
    ``NW``·RT_OUT_DW outputs along the axis one slice (2, kmax,
    NW·RT_OUT_DW, 2P + 1), hi then lo, each output's band row, zero past
    the grid and for k ≥ len(labs)."""
    n_a, W = hi.shape[1], 2 * P + 1
    TA = NW * RT_OUT_DW
    nb = math.ceil(n_a / TA)
    a = (torch.arange(nb, device=hi.device)[:, None] * TA
         + torch.arange(TA, device=hi.device)[None, :])
    valid = (a < n_a)[..., None]
    a = a.clamp(max=n_a - 1)
    out = torch.zeros((nb, 2, kmax, TA, W), dtype=torch.float32,
                      device=hi.device)
    for h, src in enumerate((hi, lo)):
        for k, lab in enumerate(labs):
            out[:, h, k] = torch.where(valid, src[lab][a], 0)
    return out.contiguous()


def k5r_tables(plan: KronPlan) -> list:
    """K5r's band tables, per run of terms those of passes A, B and C, hi
    then lo (``kron.column_table``, :func:`_strided_table`), made on the
    plan's device once and kept on the plan."""
    tiling = tuple(plan.tiling)
    if tiling not in plan._tables:
        _, _, wb, wc = tiling
        hi, lo = plan.bands, plan.bands_lo
        plan._tables[tiling] = [
            (column_table(hi[2], sp["u_lab"], CAPS_DW["u"], LANES,
                          torch.float32, lo[2]),
             _strided_table(hi[1], lo[1], sp["v_lab"], CAPS_DW["v"], wb,
                            plan.P),
             _strided_table(hi[0], lo[0], sp["w_lab"], CAPS_DW["w"], wc,
                            plan.P))
            for sp in plan.plans]
    return plan._tables[tiling]


def k5r_launch_pass(pass_: str, plan: KronPlan, args, stream, run: int = 0):
    """Launch one K5r pass (``"A"``, ``"B"`` or ``"C"``) of run ``run`` with
    the compiled entry's arguments ``args`` (pointers, geo, that run's
    plan, negate, last), the plan's scratch and the pass's band table, and
    count it: A reads x and writes the u pairs into ``plan.scratch``, B
    reads them and writes the v pairs, C reads those and writes the result
    (:func:`k5r_scratch_fields` views the scratch)."""
    table = k5r_tables(plan)[run][RT_PASSES.index(pass_)]
    _raise_if(_library().kron_residual_dw_rt(
        RT_PASSES.index(pass_), *args, plan.scratch.data_ptr(),
        table.data_ptr(), stream), f"residual_kron_df K5r pass {pass_}")
    residual_kron_df.launches += 1
    _count.count(residual_kron_df.runtime, torch.float32, pass_)


def k5r_scratch_fields(plan: KronPlan):
    """(u, v): a K5r plan's scratch as the kCU u pairs and the kCV v pairs,
    each pair two (n0, n1, n2) fields (hi, lo)."""
    f = plan.scratch.view(-1, *plan.n3)
    nu = CAPS_DW["u"]
    pairs = [(f[2 * k], f[2 * k + 1]) for k in range(nu + CAPS_DW["v"])]
    return pairs[:nu], pairs[nu:]


def k5r_pass_plain(pass_: str, plan: KronPlan, sp: dict, src, bh=None,
                   bl=None, acc=None, negate: bool = False,
                   last: bool = True):
    """Plain PyTorch version of one K5r pass of the run of terms ``sp``
    (one of ``plan.plans``), on (n3) double-word fields (hi, lo):

    - ``"A"`` (axis 2): ``src`` the pair x → the u pairs (``sp["u_lab"]``);
    - ``"B"`` (axis 1): ``src`` the u pairs → the v pairs
      (``sp["v_src"]``, ``sp["v_lab"]``);
    - ``"C"`` (axis 0): ``src`` the v pairs → one contraction per distinct
      history (``sp["w_src"]``, ``sp["w_lab"]``), the terms added in order
      onto ``acc`` (the earlier runs' sum, or the first term assigned);
      ``last`` returns b − sum (``negate``: its negation, word by word),
      else the sum.

    Each tap's operations and their order are the kernel's."""
    P, per = plan.P, plan.per3
    bands = list(zip(plan.bands, plan.bands_lo))
    if pass_ == "A":
        x = tuple(t.reshape(plan.n3) for t in src)
        return [_apply_band_1d_axis_df(*(B[lab] for B in bands[2]), *x, 2, P,
                                       per[2]) for lab in sp["u_lab"]]
    if pass_ == "B":
        return [_apply_band_1d_axis_df(*(B[lab] for B in bands[1]), *src[s],
                                       1, P, per[1])
                for s, lab in zip(sp["v_src"], sp["v_lab"])]
    if pass_ != "C":
        raise ValueError(f"unknown K5r pass {pass_!r}")
    w = [_apply_band_1d_axis_df(*(B[lab] for B in bands[0]), *src[s], 0, P,
                                per[0])
         for s, lab in zip(sp["w_src"], sp["w_lab"])]
    axh, axl = (None, None) if acc is None else acc
    for k in sp["term_w"]:
        axh, axl = w[k] if axh is None else dw_add(axh, axl, *w[k])
    if not last:
        return axh, axl
    rh, rl = dw_add(bh.reshape(plan.n3), bl.reshape(plan.n3), -axh, -axl)
    return dw_neg(rh, rl) if negate else (rh, rl)


def k5r_passes_plain(plan: KronPlan, bh, bl, xh, xl, negate: bool = False):
    """K5r's three plain passes chained as the card chains them: per run of
    terms A, B, C, every run but the last writing the sum of the terms so
    far, the last b − sum; equal to :func:`residual_kron_df_plain` word for
    word."""
    acc = None
    for k, sp in enumerate(plan.plans):
        last = k == len(plan.plans) - 1
        u = k5r_pass_plain("A", plan, sp, (xh, xl))
        v = k5r_pass_plain("B", plan, sp, u)
        acc = k5r_pass_plain("C", plan, sp, v, bh, bl, acc, negate, last)
    return tuple(t.reshape(plan.npts) for t in acc)


residual_kron_df.launches = 0
residual_kron_df.runtime = SimpleNamespace()   # K5r's among them, per pass
_count.attach(residual_kron_df.runtime, RT_PASSES)


def k5_resources(plan: KronPlan) -> dict:
    """What K5's first launch of ``plan`` gets on the card: registers and
    local memory (spilled registers) a thread, shared memory a block, blocks
    an SM holds at once, threads a block.  For K5r the same of each pass
    under ``passes`` (A, B, C), and at the top level the most registers,
    local memory, shared memory and threads and the fewest blocks an SM of
    the three."""
    geo, ints = _df_c_args(plan)[:2]

    def query(pass_):
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(plan.device):
            _raise_if(_library().kron_residual_dw_resources(
                geo, ints, out, pass_), "k5_resources")
        return {"registers": out[0], "local_bytes": out[1],
                "smem_bytes": out[2], "blocks_per_sm": out[3]}

    if not plan.runtime:
        return {**query(-1), "threads": geo[10]}
    passes = {p: {**query(i), "threads": LANES * w}
              for i, (p, w) in enumerate(zip(RT_PASSES, plan.tiling[1:]))}
    return {**{k: max(r[k] for r in passes.values())
               for k in ("registers", "local_bytes", "smem_bytes",
                         "threads")},
            "blocks_per_sm": min(r["blocks_per_sm"] for r in passes.values()),
            "passes": passes}


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
    with span("poms.k6r", pairs=pairs, sqrt=sqrt):
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


def dw_update(mode: str, *ops, out=None):
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

    ``out``: the contiguous f32 fields of the first's shape and device to
    write the results into, one per result, returned in its place; an
    output may be one of the fields read (each point is read before it is
    written).

    CPU tensors take :func:`dw_update_plain`; CUDA tensors launch K6u or
    raise."""
    if mode not in UPDATE_MODES:
        raise ValueError(f"unknown dw_update mode {mode!r}")
    n_in, n_s, n_out = UPDATE_MODES[mode]
    if len(ops) != n_in + n_s:
        raise ValueError(f"dw_update({mode!r}) takes {n_in} fields and "
                         f"{n_s} scalars, got {len(ops)} operands")
    first = ops[0]
    if mode == "dwrr" and ops[3] is None:
        n_out = 2
    if out is not None:
        out = _check_out(mode, out, first, n_out)
    if first.device.type == "cpu":
        got = dw_update_plain(mode, *ops)
        if out is None:
            return got
        for buf, t in zip(out, (got,) if n_out == 1 else got):
            buf.copy_(t)
        return out[0] if n_out == 1 else out
    if first.device.type != "cuda":
        raise NotImplementedError(
            f"dw_update on {first.device.type} tensors")
    with span("poms.k6u", mode=mode, ops=ops):
        return _launch_update(mode, ops[:n_in], ops[n_in:], n_out, out)


dw_update.launches = 0


def _check_out(mode: str, out, first, n_out: int):
    """``out`` of :func:`dw_update` as a tuple, or raise: ``n_out``
    contiguous f32 fields of ``first``'s shape on its device."""
    out = tuple(out)
    if len(out) != n_out:
        raise ValueError(f"dw_update({mode!r}) writes {n_out} fields, "
                         f"got {len(out)} in out")
    for j, t in enumerate(out):
        if t.dtype != torch.float32:
            raise TypeError(f"out {j} is {t.dtype}, not float32")
        if t.shape != first.shape or t.device != first.device \
                or not t.is_contiguous():
            raise ValueError(
                f"out {j} is {tuple(t.shape)} on {t.device} (contiguous "
                f"{t.is_contiguous()}), expected a contiguous "
                f"{tuple(first.shape)} on {first.device}")
    return out


def _launch_update(mode: str, fields, scalars, n_out: int, out=None):
    """K6u on the card: :func:`dw_update`'s checks of the fields and
    scalars, then one launch into ``out`` (checked by :func:`_check_out`)
    or into new fields."""
    first = fields[0]
    n_s = len(scalars)
    if mode == "dwrr":
        if (fields[3] is None) != (fields[4] is None):
            raise ValueError("ap and rf are given or omitted together")
    elif any(t is None for t in fields):
        raise ValueError(f"dw_update({mode!r}) needs every field")
    flat = [_flat_f32(f"field {j}", t, first) for j, t in enumerate(fields)]
    for s in scalars:
        if s.dtype != torch.float64 or s.numel() != 1 \
                or s.device != first.device:
            raise TypeError("the scalars are 0-dim float64 tensors on the "
                            "fields' device")
    outs = list(out) if out is not None else [
        torch.empty(first.shape, dtype=torch.float32, device=first.device)
        for _ in range(n_out)]
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
