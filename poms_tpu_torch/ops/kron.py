"""K1: the fused Kronecker-sum apply y = Σ_r (B_r⁽⁰⁾ ⊗ B_r⁽¹⁾ ⊗ B_r⁽²⁾)·x and
its residual, D⁻¹ and Chebyshev epilogues.

Counterpart of ``poms_tpu/ops/pallas/kron.py::kron_apply_pallas``.
:func:`kron_mode` runs one pass over an unpadded interior field in one of

- ``apply``:    y = A x
- ``residual``: r = b − A x
- ``dinv``:     y = (A x) / diag(A)
- ``cheb``:     z = (b − A x) / diag(A); d ← c1·d + c2·z; x_new = x + d

For a CUDA tensor it launches the hand-written kernel of
``csrc/kron_apply.cu`` (f32, f64 or bf16; 1D and 2D lifted to 3D) or raises:
K1, compiled at ``INSTANTIATED_P`` and taken by plans at the half-widths
of ``COMPILED_P`` (1-3), or K1r, which takes the half-width at run time
(every other half-width: spline degrees 4 and up) as three one-axis passes
through a scratch buffer of the plan (:func:`k1r_launch_pass`, each pass's
plain version :func:`k1r_pass_plain`); for a CPU tensor it runs
:func:`kron_mode_plain`, built on the shared-partial chain of 1D axis
contractions of ``poms_tpu/core/kron.py::_apply_interior``
(:func:`kron_apply_plain`).  ``kron_mode.launches[mode]`` counts kernel
launches per mode (``launches_by_dtype[name][mode]`` those of one
instantiation), ``kron_mode.runtime.launches[f"{mode}.{pass}"]`` those of
each K1r pass among them, and ``kron_apply.launches`` those of ``apply``.

A bf16 operator (bf16 bands and fields) is computed in f32 and rounded once
per output value, by the kernel and by the plain version alike
(:func:`kron_mode` casts the operands up, runs the f32 expressions and
rounds); the JAX package's Pallas kernel is f32 only and its bf16 cycle goes
through XLA in bf16, so the port's is at least as exact and not bitwise with
it.

What the kernel needs beyond the field is built once per operator by
:func:`build_kron_plan`: the terms that share their bands on every axis but one
folded into one (:func:`fold_terms`), the distinct bands of each axis stacked
and zero-padded to one compiled half-width (or, for K1r, at their own), the
centre columns for the in-kernel diagonal, the **sharing plan** (which
(partial, band) pairs each axis contracts, and which partials are summed before
the last contraction) as small integer arrays, and the tiling.
:func:`plan_apply` executes the same control data in plain PyTorch, so it is
tested where no card is.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import torch

from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.ops import _build, _count
from poms_tpu_torch.ops.stencil import K2_SMEM

__all__ = ["MODES", "kron_apply", "kron_apply_plain", "kron_mode",
           "kron_mode_plain", "kron_mode_plain_bf16", "apply_band_1d_axis",
           "band_labels",
           "sharing_plan", "chunk_terms", "fold_terms", "build_kron_plan",
           "plan_scratch",
           "plan_apply",
           "diagonal_from_columns", "kron_tiling", "k1_step_cost",
           "k1_smem_bytes", "rows_options", "k1_tiling", "warp_widths",
           "KronPlan",
           "stack_bands", "refuse_half_width", "COMPILED_P",
           "INSTANTIATED_P", "k1r_smem",
           "k1r_pass_smem", "k1r_step_cost", "runtime_tiling",
           "widest_half_width", "SMALLEST_BLOCK", "RT_PASSES",
           "k1_resources", "k1r_launch_pass", "k1r_scratch_fields",
           "k1r_pass_plain", "k1r_passes_plain"]

MODES = ("apply", "residual", "dinv", "cheb")
_KERNELS = {torch.float32: "kron_apply_f32", torch.float64: "kron_apply_f64",
            torch.bfloat16: "kron_apply_bf16"}
_KERNELS_RT = {dt: name.replace("apply_", "apply_rt_")
               for dt, name in _KERNELS.items()}
# mirrored in csrc/kron_apply.cu (kCU, kCV, kCG, the instantiated
# half-widths, kMaxThreads, columns, rows_compiled and min_blocks): partials
# one launch may hold per axis, and the half-widths K1 is compiled at (every
# dtype)
CAPS = {"u": 2, "v": 3, "g": 2}
INSTANTIATED_P = (1, 2, 3, 5, 8)
# The half-widths plans take the compiled K1 at (``build_kron_plan``'s
# default); every other runs on K1r at its own.  Chosen end to end: the
# headline dw-PCG at 128³ elements steps faster from degree 4 on with K1r
# and K5r than with the compiled kernels padded or not (NVIDIA H100 80GB
# HBM3; bench/k1_compare.py --route, PERF.md section 5), so only 1-3 stay
# compiled.  K5 routes by ops/twofloat.py::COMPILED_P_DW.
COMPILED_P = (1, 2, 3)
SM_COUNT = 132   # H100 SXM: the tiling's cost model where no card is asked
SM_SMEM = 233472          # shared memory of an H100 SM, for blocks an SM
SM_REGS = 65536           # registers of an H100 SM
MAX_THREADS = 256         # block size limit
STAGES = 4                # kron::kStages: window buffers in the ring
K1_DIAG_TERMS = 3         # kRD: terms whose diagonal columns K1 tabulates
# K1's cost model (k1_step_cost) per micro-tile height (rows a thread), µs:
# fitted to a sweep of tilings at both heights on an H100
# (bench/k1_compare.py --sweep)
K1_COST = {2: {"step": 1.22, "halo2": 2.499e-04, "halo1": 2.893e-04,
               "segment": 1.41e-04, "block": 0.5361},
           1: {"step": 0.9831, "halo2": 2.822e-04, "halo1": 2.659e-04,
               "segment": 5.436e-05, "block": 0.749}}
# the run-time kernels (K1r, K5r: three one-axis passes, csrc/kron_pass.cuh):
# 32 columns a warp in the strided passes, at most 8 warps a block; K1r's
# pass A owns 2 columns of RT_ROWS_A rows a thread, its passes B and C
# RT_OUT outputs along the axis (kRowsA, kOutR of csrc/kron_apply.cu)
LANES = 32
RT_WARPS = (8, 4, 2, 1)
RT_ROWS_A = 4
RT_OUT = 4
RT_PASSES = ("A", "B", "C")
# the smallest block of a run-time kernel: one warp a pass (K1r's pass A
# on 64 columns); a half-width whose smallest block exceeds the shared
# memory a block may have is refused on the card
SMALLEST_BLOCK = (1,)


def arithmetic_itemsize(dtype: torch.dtype) -> int:
    """Bytes of the type K1 computes in: a bf16 operator is computed in f32,
    so its instantiation, tile and cost model are the f32 kernel's."""
    return 4 if dtype == torch.bfloat16 else torch.empty(
        (), dtype=dtype).element_size()


def columns_per_thread(itemsize: int, P: int) -> int:
    """Tile columns one thread owns in K1's instantiation (``itemsize`` of
    the arithmetic type): two where the registers allow it (f32, P ≤ 3), so
    T2 is even there."""
    return 2 if itemsize == 4 and P <= 3 else 1


def rows_options(P: int) -> Tuple[int, ...]:
    """Tile rows one thread may own in K1 (its register micro-tile is rows
    × :func:`columns_per_thread`; csrc/kron_apply.cu::rows_compiled): 2 or
    1 at P ≤ 3, which the tile model chooses per grid with the tile (2
    where blocks fill the SMs, 1 on coarse grids, where a thread's chain of
    work sets the pace); 1 for the wider bands."""
    return (2, 1) if P <= 3 else (1,)


def warp_widths(cols: int, rows: int) -> Tuple[int, ...]:
    """K1's tile widths offered besides those that divide axis 2 evenly:
    where a thread owns two rows, the widths whose row groups of threads
    owning ``cols`` columns fill 8, 16 or 32 lanes (at 513³ and 257³ the
    64-wide tile beat every even width on an H100, its last tile ragged);
    none at one row."""
    if rows == 1:
        return ()
    return tuple(cols * lanes for lanes in (8, 16, 32))


def k1_smem_bytes(itemsize: int, P: int, T1: int, T2: int, chunk: int,
                  rows: int) -> int:
    """Shared memory of a K1 block (csrc/kron_apply.cu, ``K1Smem``): the
    ring of window buffers (``STAGES`` planes in flight and, at P ≤ 3,
    the P + 1 of the outputs still open, whose x the epilogue reads from
    them), the u partials of two planes, the axis-1 band table (``rows``
    a thread), the axis-0 band rows of the run, the diagonal's centre
    columns and the window's int32 source offsets, each section 16-byte
    aligned."""
    def up16(b):
        return -(-b // 16) * 16

    WR, WC, W = T1 + 2 * P, T2 + 2 * P, 2 * P + 1
    sizes = ((STAGES + (P + 1 if P <= 3 else 0)) * WR * WC * itemsize,
             2 * CAPS["u"] * WR * T2 * itemsize,
             CAPS["v"] * T1 * (rows + 2 * P) * itemsize,
             CAPS["g"] * (chunk + 4 * P) * W * itemsize,
             K1_DIAG_TERMS * (chunk + T1 + T2) * itemsize, WR * WC * 4)
    return sum(up16(s) for s in sizes)


def k1_step_cost(itemsize: int, P: int, rows: int = 1):
    """K1's cost model for :func:`kron_tiling` at ``rows`` rows a thread,
    in µs, its constants ``K1_COST[rows]`` fitted to a sweep of tilings at
    the headline solve's level shapes (513³ to 9³, p = 3, f32,
    ``bench/k1_compare.py --sweep``) on an H100: blocks run in waves of as
    many as an SM holds (by its registers, 128 a thread where that
    suffices, f32 at P ≤ 3, else 255, and by its shared memory); a block
    marches over its run's planes and 2P more, a step costing
    ``"step"`` (its barrier and the latency of its chain) plus the work of
    the points the SM's resident blocks hold, but never fewer than four
    warps' (one a scheduler: below that a thread's own chain sets the
    pace, which is why a thread owning one row wins on coarse grids): per
    point, the axis-2 halo (window columns over tile columns, ``"halo2"``),
    the axis-1 halo (window rows over tile rows, ``"halo1"``) and the rows
    of the tile a warp's threads touch (``"segment"`` each: a warp of one
    row group reads and writes whole runs of a row), all scaled by the
    taps; each block adds ``"block"`` over the SMs (its start and set-up).
    Infinite for a block over the card's shared memory."""
    regs = 128 if itemsize == 4 and P <= 3 else 255
    cols = columns_per_thread(itemsize, P)
    taps = (2 * P + 1) / 7
    k = K1_COST[rows]

    def cost(T1, T2, threads, chunk, blocks, sms):
        smem = k1_smem_bytes(itemsize, P, T1, T2, chunk, rows)
        if smem > K2_SMEM:
            return math.inf
        per_sm = max(1, min(SM_REGS // (regs * threads),
                            SM_SMEM // (smem + 1024), 32))
        waves = math.ceil(blocks / (sms * per_sm))
        resident = min(per_sm, math.ceil(blocks / waves / sms))
        nc = T2 // cols   # threads of a row group
        segments = (32 // nc + (32 % nc > 0) if nc <= 32
                    else 1 + (nc % 32 > 0))
        points = max(resident * T1 * T2, 4 * 32 * rows * cols)
        work = points * taps * (k["halo2"] * (T2 + 2 * P) / T2
                                + k["halo1"] * (T1 + 2 * P) / T1
                                + k["segment"] * segments)
        return (waves * (chunk + 2 * P) * (k["step"] + work)
                + k["block"] * blocks / sms)

    return cost


def k1r_pass_smem(itemsize: int, P: int, pass_: str, warps: int,
                  TL: int = 2 * LANES) -> int:
    """Shared memory of one K1r pass's block in bytes
    (``csrc/kron_apply.cu::smem_a``/``smem_bc``; ``itemsize`` of the
    arithmetic type): its staged tile and band table; pass A's tile the
    window of its rows (TL + 2P wide), its table the tile's axis-2 band
    rows; B's and C's tiles the block's outputs and 2P halo rows, 32
    columns, per source, their tables each thread's band rows (RT_OUT + 2P
    taps a row)."""
    W, npb = 2 * P + 1, RT_OUT + 2 * P
    if pass_ == "A":
        words = (_pass_blocks((1, 1, TL), "A", warps, TL, RT_ROWS_A,
                              RT_OUT)[1] * (TL + 2 * P)
                 + CAPS["u"] * W * TL)
    else:
        rows = warps * RT_OUT + 2 * P
        src, nb = ((CAPS["u"], CAPS["v"]) if pass_ == "B"
                   else (CAPS["g"], CAPS["g"]))
        words = src * rows * LANES + nb * warps * npb * RT_OUT
    return itemsize * words


def k1r_smem(itemsize: int):
    """K1r's shared memory, ``smem(P, warps)`` in bytes: its largest pass
    at ``warps`` warps a block (:func:`k1r_pass_smem`)."""
    return lambda P, warps: max(k1r_pass_smem(itemsize, P, p, warps)
                                for p in RT_PASSES)


def widest_half_width(smem) -> int:
    """The widest half-width whose smallest block (``SMALLEST_BLOCK``)
    takes no more than the shared memory a block may have, for a run-time
    kernel's ``smem(P, warps)``."""
    P = 1
    while smem(P + 1, *SMALLEST_BLOCK) <= K2_SMEM:
        P += 1
    return P


def _pass_blocks(n3, pass_, warps, TL, rows_a, out_r, cols_a=2):
    """Blocks of one run-time pass, and a block's outputs along its axis (or
    rows, pass A) and columns: pass A's threads own ``cols_a`` columns of
    ``rows_a`` rows, the strided passes' ``out_r`` outputs along the axis."""
    n0, n1, n2 = n3
    if pass_ == "A":
        rows = (LANES * warps) // (TL // cols_a) * rows_a
        return math.ceil(n2 / TL) * math.ceil(n0 * n1 / rows), rows, TL
    per = warps * out_r
    along = n1 if pass_ == "B" else n0
    return (math.ceil(n2 / LANES) * math.ceil(along / per)
            * (n0 if pass_ == "B" else n1)), per, LANES


def k1r_step_cost(itemsize: int, P: int):
    """K1r's cost model for :func:`runtime_tiling`, in arbitrary units:
    ``cost(n3, pass, warps, TL, sms)`` is the work of all blocks (a
    block's: the words it stages, the halo and its band table included,
    and its multiply-adds at 8 a staged word), as if there were two blocks
    an SM where there are fewer; infinite for a block over the card's
    shared memory.  The staged band table makes larger blocks cheaper per
    output, as ``bench/k1_compare.py --sweep-rt`` measures on the card."""
    W = 2 * P + 1
    fma = {"A": CAPS["u"], "B": CAPS["v"], "C": CAPS["g"]}
    src = {"A": 1, "B": CAPS["u"], "C": CAPS["g"]}
    table = {"A": lambda w, TL: CAPS["u"] * W * TL,
             "B": lambda w, TL: CAPS["v"] * w * (RT_OUT + 2 * P) * RT_OUT,
             "C": lambda w, TL: CAPS["g"] * w * (RT_OUT + 2 * P) * RT_OUT}

    def cost(n3, pass_, warps, TL, sms):
        need = k1r_pass_smem(itemsize, P, pass_, warps, TL)
        if need > K2_SMEM:
            return math.inf
        blocks, rows, cols = _pass_blocks(n3, pass_, warps, TL, RT_ROWS_A,
                                          RT_OUT)
        staged = src[pass_] * (rows + 2 * P) * cols + table[pass_](warps, TL)
        work = staged + rows * cols * W * fma[pass_] / 8
        return max(blocks, 2 * sms) * work

    return cost


def runtime_tiling(n3, P: int, cost, sms: int = SM_COUNT,
                   max_cols: int = 2 * LANES):
    """(TL, warps A, warps B, warps C): the run-time kernels' launch shape.
    Pass A's tiles are ``TL`` columns wide (even, an even split of axis 2
    into tiles of at most ``max_cols``; K5r's are 32); each pass takes the
    block size of ``RT_WARPS`` with the least modelled time,
    ``cost(n3, pass, warps, TL, sms)`` (:func:`k1r_step_cost`,
    ``twofloat.k5_step_cost(runtime=True)``), infinite for a block that does
    not fit.  Raises where no block of some pass fits."""
    n2 = n3[2]
    if max_cols == LANES:
        TL = LANES
    else:
        k = math.ceil(n2 / max_cols)
        TL = 2 * math.ceil(math.ceil(n2 / k) / 2)
    shape = [TL]
    for pass_ in RT_PASSES:
        c, warps = min((cost(n3, pass_, w, TL, sms), w) for w in RT_WARPS)
        if math.isinf(c):
            raise ValueError(f"no tiling of {n3} at half-width {P} fits a "
                             f"block")
        shape.append(warps)
    return tuple(shape)


def apply_band_1d_axis(band1: torch.Tensor, x: torch.Tensor, axis: int,
                       pad: int, periodic: bool = False) -> torch.Tensor:
    """y[..., i, ...] = Σ_t band1[i, t] · x_pad[..., i + t, ...].

    ``x`` is unpadded along ``axis``; zero or wrapped padding is applied
    here.  band1 has shape (n_axis, 2p+1).
    """
    n = x.shape[axis]
    nd = x.ndim
    pads = [pad if b == axis else 0 for b in range(nd)]
    x_pad = ghost_pad(x, pads, [periodic] * nd)
    bshape = [1] * nd
    bshape[axis] = n
    out = None
    for t in range(2 * pad + 1):
        term = band1[:, t].reshape(bshape) * x_pad.narrow(axis, t, n)
        out = term if out is None else out + term
    return out


def band_labels(terms) -> List[List[int]]:
    """label[a][r]: which distinct band object term r uses on axis a.

    Identity of the stored tensors defines the sharing (the operator keeps
    them alive), so equal labels mean a partial product can be reused.
    """
    labels = []
    for a in range(len(terms[0])):
        seen = {}
        row = []
        for term in terms:
            row.append(seen.setdefault(id(term[a]), len(seen)))
        labels.append(row)
    return labels


def kron_apply_plain(terms, x_int: torch.Tensor, npts, pads,
                     periodic) -> torch.Tensor:
    """Plain PyTorch K1: axis passes right to left, partials shared by
    application history (``core/kron.py:189-204`` of the JAX package)."""
    d = x_int.ndim
    labels = band_labels(terms)
    partials = {r: x_int for r in range(len(terms))}
    hist = {r: () for r in range(len(terms))}
    for a in range(d - 1, -1, -1):
        cache = {}
        for r, term in enumerate(terms):
            key = hist[r] + (labels[a][r],)
            if key not in cache:
                cache[key] = apply_band_1d_axis(term[a], partials[r], a,
                                                pads[a], periodic[a])
            partials[r] = cache[key]
            hist[r] = key
    out = None
    for r in partials:
        out = partials[r] if out is None else out + partials[r]
    return out


def diagonal_from_columns(cols) -> torch.Tensor:
    """diag(Σ_r ⊗_a B_r^(a)) from the bands' centre columns, in the order
    the kernel uses: Σ over r of ((c0[r, i]·c1[r, j])·c2[r, l]), the terms
    added in order.  ``cols[a]`` has shape (R, n_a)."""
    out = None
    for r in range(cols[0].shape[0]):
        d = None
        for c in cols:
            d = c[r] if d is None else torch.tensordot(d, c[r], dims=0)
        out = d if out is None else out + d
    return out


# -- the sharing plan --------------------------------------------------------

def _lift_labels(labels):
    """1D/2D labels as 3D: the lifted leading axes carry label 0 (one
    identity band shared by every term)."""
    lead = 3 - len(labels)
    return [[0] * len(labels[0]) for _ in range(lead)] + [list(l)
                                                           for l in labels]


def sharing_plan(labels, rows: Optional[Sequence[int]] = None) -> dict:
    """Which contractions the terms ``rows`` (default: all) need, from the
    3D labels ``labels[a][r]``.

    - ``u_lab[k]``: axis-2 band of partial u_k = B2·x;
    - ``v_src[k]``, ``v_lab[k]``: v_k = B1[v_lab]·u[v_src];
    - ``w_src[k]``, ``w_lab[k]``: the distinct full histories
      w_k = B0[w_lab]·v[w_src], and ``term_w[r]`` the one term r sums (the
      double-word kernel's last stage: no sum before the contraction);
    - ``g_lab[g]``, ``g_mult[g][k]``: K1's last stage, one contraction per
      distinct axis-0 band of Σ_k g_mult[g][k]·v_k (how many terms with
      that band end in v_k).
    """
    rows = range(len(labels[0])) if rows is None else rows
    u_lab, v, w, term_w, g_lab, ends = [], [], [], [], [], []
    for r in rows:
        l0, l1, l2 = labels[0][r], labels[1][r], labels[2][r]
        if l2 not in u_lab:
            u_lab.append(l2)
        vk = (u_lab.index(l2), l1)
        if vk not in v:
            v.append(vk)
        wk = (v.index(vk), l0)
        if wk not in w:
            w.append(wk)
        term_w.append(w.index(wk))
        if l0 not in g_lab:
            g_lab.append(l0)
        ends.append((g_lab.index(l0), v.index(vk)))
    g_mult = [[0] * len(v) for _ in g_lab]
    for g, k in ends:
        g_mult[g][k] += 1
    return {"u_lab": u_lab, "v_src": [s for s, _ in v],
            "v_lab": [l for _, l in v], "w_src": [s for s, _ in w],
            "w_lab": [l for _, l in w], "term_w": term_w, "g_lab": g_lab,
            "g_mult": g_mult}


# the sharing plan's list that each cap of a launch bounds
_CAPPED = {"u": "u_lab", "v": "v_src", "g": "g_lab", "w": "w_src",
           "t": "term_w"}


def _fits(plan: dict, caps: dict) -> bool:
    return all(len(plan[_CAPPED[k]]) <= c for k, c in caps.items())


def chunk_terms(labels, caps: dict = CAPS) -> List[List[int]]:
    """Split the terms, in order, into runs whose plan fits one launch
    (``caps``: at most so many u, v, pre-summed (g) or history (w) partials
    and terms (t)); a single term always fits."""
    chunks, cur = [], []
    for r in range(len(labels[0])):
        if cur and not _fits(sharing_plan(labels, cur + [r]), caps):
            chunks.append(cur)
            cur = []
        cur.append(r)
    chunks.append(cur)
    return chunks


def _merged_labels(labels, i: int, j: int, a: int) -> List[List[int]]:
    """``labels`` with term j folded into term i on axis ``a``: term j gone,
    term i's band on ``a`` a new one, every axis renumbered in order of
    first use (as :func:`band_labels` numbers)."""
    out = []
    for b, row in enumerate(labels):
        row = list(row)
        if b == a:
            row[i] = max(row) + 1
        del row[j]
        seen = {}
        out.append([seen.setdefault(lab, len(seen)) for lab in row])
    return out


def _sum_bands(parts) -> torch.Tensor:
    """Σ of the bands ``parts``, added in f64 and rounded once to their
    dtype."""
    total = None
    for B in parts:
        total = B.double() if total is None else total + B.double()
    return total.to(parts[0].dtype)


def fold_terms(terms, labels, caps: dict = CAPS):
    """(terms, labels) with every pair of terms that shares its bands on
    every axis but one folded into one term, whose band on that axis is the
    sum of theirs (:func:`_sum_bands`): B⊗C⊗D + B'⊗C⊗D = (B + B')⊗C⊗D.
    Pairs are taken in order, again until none folds, and a fold is kept
    only where the terms then take no more runs of ``caps``
    (:func:`chunk_terms`) than the unfolded ones.  ``labels[a][r]`` (not
    lifted) names the sharing; an operator with no such pair keeps its band
    objects and labels.  The periodic shifted operator σ·M⊗M⊗M + K⊗M⊗M +
    M⊗K⊗M + M⊗M⊗K folds to (σM + K)⊗M⊗M + M⊗K⊗M + M⊗M⊗K, the Dirichlet
    operator's sharing: one run of K1's caps, not two."""
    d = len(labels)
    parts = [[(B,) for B in term] for term in terms]
    runs = len(chunk_terms(_lift_labels(labels), caps))
    folded = True
    while folded:
        folded = False
        for i, j in itertools.combinations(range(len(parts)), 2):
            differ = [a for a in range(d) if labels[a][i] != labels[a][j]]
            if len(differ) != 1:
                continue
            a = differ[0]
            trial = _merged_labels(labels, i, j, a)
            if len(chunk_terms(_lift_labels(trial), caps)) > runs:
                continue
            parts[i][a] = parts[i][a] + parts[j][a]
            del parts[j]
            labels, folded = trial, True
            break
    return ([tuple(p[0] if len(p) == 1 else _sum_bands(p) for p in term)
             for term in parts], labels)


def _tiles(n3, threads_max: int, cols: int, rows: int = 1,
           extra: Sequence[int] = ()):
    """The compiled kernels' candidate (T1, T2, chunk, blocks): tile widths
    of 16 to 64 columns that divide axis 2 evenly, and the ``extra`` widths
    narrower than axis 2 (K1's :func:`warp_widths`); the tallest tile for
    three block sizes (a thread owning ``rows`` × ``cols`` points, T1 a
    multiple of ``rows``); up to 64 runs of planes."""
    n0, n1, n2 = n3
    t2_cap = threads_max * cols if n1 == 1 else 64
    k2_min = math.ceil(n2 / t2_cap)
    widths = []   # (T2, tiles along axis 2)
    for k2 in range(k2_min, min(n2, k2_min + 63) + 1):
        T2 = cols * math.ceil(n2 / k2 / cols)
        if T2 < min(16, n2):
            break
        widths.append((T2, k2))
    widths += [(T2, math.ceil(n2 / T2)) for T2 in extra
               if T2 < n2 and T2 not in (w for w, _ in widths)]
    for T2, k2 in widths:
        for budget in (threads_max, threads_max // 2, threads_max // 4):
            if budget < T2 // cols:
                continue
            k1 = math.ceil(n1 / (budget // (T2 // cols) * rows))
            T1 = rows * math.ceil(math.ceil(n1 / k1) / rows)
            for nchunks in range(1, min(n0, 64) + 1):
                chunk = math.ceil(n0 / nchunks)
                if math.ceil(n0 / chunk) == nchunks:
                    yield T1, T2, chunk, k1 * k2 * nchunks


def kron_tiling(n3, P: int, threads_max: int, cost, sms: int = SM_COUNT,
                cols: int = 1, rows: int = 1, extra: Sequence[int] = ()):
    """(T1, T2, chunk): a block owns a T1 × T2 column of the (axis 1,
    axis 2) grid and marches over ``chunk`` output planes of axis 0; a
    thread owns ``rows`` × ``cols`` neighbouring points (T1 and T2 are
    multiples of them).

    Tiles divide each axis evenly (a 2^k+1 grid gets no nearly empty last
    tile), but for the ``extra`` widths offered (K1's :func:`warp_widths`):
    those are taken only narrower than axis 2, and their last tile along it
    may be ragged (fewer than half its columns idle; the cost model weighs
    the idle lanes).  Among tile widths of 16 to 64 columns, three block
    sizes and up to 64 runs of planes the one with the least modelled time
    is taken:
    ``cost(T1, T2, threads, chunk, blocks, sms)`` is the kernel's own model
    (K1's: :func:`k1_step_cost`), infinite for a block that does not fit.
    Splitting axis 0 adds 2P halo planes per run but fills the SMs at small
    grids.
    """
    best = _least_tiling(n3, threads_max, cost, sms, cols, rows, extra)
    if best is None or math.isinf(best[0]):
        raise ValueError(f"no tiling of {n3} at half-width {P} fits a block")
    return best[1:]


def _least_tiling(n3, threads_max, cost, sms, cols, rows, extra):
    """(modelled time, T1, T2, chunk) of :func:`kron_tiling`'s choice, or
    None where ``_tiles`` offers nothing."""
    best = None
    for T1, T2, chunk, blocks in _tiles(n3, threads_max, cols, rows, extra):
        threads = 32 * math.ceil(T1 // rows * (T2 // cols) / 32)
        c = cost(T1, T2, threads, chunk, blocks, sms)
        if best is None or c < best[0]:
            best = (c, T1, T2, chunk)
    return best


def k1_tiling(n3, P: int, itemsize: int, threads_max: int = MAX_THREADS,
              sms: int = SM_COUNT, cols: Optional[int] = None,
              rows: Sequence[int] = None, cost=None, widths=None):
    """(rows, (T1, T2, chunk)): K1's micro-tile height, among ``rows``
    (default :func:`rows_options`), and tile, the pair with the least
    modelled time (``cost(rows)``, default :func:`k1_step_cost`; the extra
    widths ``widths(rows)``, default :func:`warp_widths`)."""
    cols = columns_per_thread(itemsize, P) if cols is None else cols
    best = None
    for R in rows_options(P) if rows is None else rows:
        c = (k1_step_cost(itemsize, P, R) if cost is None else cost(R))
        w = warp_widths(cols, R) if widths is None else widths(R)
        got = _least_tiling(n3, threads_max, c, sms, cols, R, w)
        if got is not None and (best is None or got[0] < best[0][0]):
            best = (got, R)
    if best is None or math.isinf(best[0][0]):
        raise ValueError(f"no tiling of {n3} at half-width {P} fits a block")
    return best[1], best[0][1:]


@dataclass
class KronPlan:
    """Per-operator launch data of K1 (and K5): see the module docstring."""
    terms: tuple                  # the operator's bands (the plain versions)
    ndim: int
    npts: Tuple[int, ...]
    pads: Tuple[int, ...]
    periodic: Tuple[bool, ...]
    n3: Tuple[int, int, int]
    per3: Tuple[bool, bool, bool]
    pads3: Tuple[int, int, int]
    P: int                        # common half-width the bands are padded to
    labels: List[List[int]]       # lifted to 3D
    bands: List[torch.Tensor]     # per axis (n_labels, n_a, 2P+1)
    cols: List[torch.Tensor]      # per axis (R, n_a): centre columns
    chunks: List[List[int]]       # runs of terms, one launch each
    plans: List[dict]             # sharing plan of each run
    tiling: Optional[Tuple[int, int, int]]   # None: no block fits (CPU)
    tcols: int                    # tile columns per thread
    dtype: torch.dtype
    device: torch.device
    runtime: bool = False         # P is no compiled half-width: K1r / K5r
    trows: int = 1                # tile rows per thread
    bands_lo: Optional[List[torch.Tensor]] = None   # K5: the lo words
    # K1r / K5r on the card: the passes' scratch (see build_kron_plan) and
    # their band tables per launch shape (k1r_tables, twofloat.k5r_tables)
    scratch: Optional[torch.Tensor] = None
    _tables: dict = field(default_factory=dict)
    _cargs: list = field(default_factory=list)
    _diag: Optional[torch.Tensor] = None
    _f32: Optional[tuple] = None

    @property
    def n_terms(self) -> int:
        return len(self.labels[0])

    def diagonal(self) -> torch.Tensor:
        """diag(A) by the kernel's rule, cached (the plain versions' use)."""
        if self._diag is None:
            self._diag = diagonal_from_columns(
                self.cols[3 - self.ndim:]).reshape(self.npts)
        return self._diag

    def operands_f32(self):
        """(terms, diag) of a bf16 operator cast to f32, each distinct band
        once, the diagonal by the kernel's rule from the cast centre columns
        (cached: what the bf16 plain version computes with)."""
        if self._f32 is None:
            cast = {}
            terms = tuple(tuple(cast.setdefault(id(B), B.to(torch.float32))
                                for B in term) for term in self.terms)
            diag = diagonal_from_columns(
                [c.to(torch.float32) for c in self.cols[3 - self.ndim:]]
            ).reshape(self.npts)
            self._f32 = (terms, diag)
        return self._f32


def _compiled_half_width(pads, half_widths=COMPILED_P) -> int:
    """The first of ``half_widths`` that holds the bands, or else their own
    half-width (the run-time kernels')."""
    p = max(max(pads), 1)
    for P in half_widths:
        if P >= p:
            return P
    return p


def refuse_half_width(pads, device: torch.device, smem, what: str):
    """On the card, raise where not even the smallest block of the run-time
    kernel ``what`` (``SMALLEST_BLOCK``: one warp a pass) fits the shared
    memory a block may have; ``smem(P, warps)`` is its bytes
    (:func:`k1r_smem`, ``twofloat.k5r_smem``).  The plain versions on the
    CPU take any half-width."""
    p = max(max(pads), 1)
    need = smem(p, *SMALLEST_BLOCK)
    if device.type == "cuda" and need > K2_SMEM:
        raise RuntimeError(
            f"{what} cannot stage a block at half-width {p} (spline degree "
            f"{p}): its smallest block (one warp a pass) "
            f"takes {need} bytes of shared memory, and a block may have "
            f"{K2_SMEM}; it takes half-widths up to "
            f"{widest_half_width(smem)}")


def stack_bands(terms, labels, n3, pads3, P: int, centre: float = 1.0):
    """Per lifted axis, the distinct bands (by ``labels[a][r]``) stacked as
    (n_labels, n_a, 2P+1), each zero-padded to half-width P about its
    centre; a lifted leading axis gets one 1 × (2P+1) band whose only entry
    is ``centre``."""
    first = terms[0][0]
    lead = 3 - len(terms[0])
    bands = []
    for a in range(3):
        if a < lead:
            stack = torch.zeros((1, 1, 2 * P + 1), dtype=first.dtype,
                                device=first.device)
            stack[0, 0, P] = centre
        else:
            p = pads3[a]
            distinct = {}
            for r, term in enumerate(terms):
                distinct.setdefault(labels[a][r], term[a - lead])
            stack = torch.zeros((len(distinct), n3[a], 2 * P + 1),
                                dtype=first.dtype, device=first.device)
            for lab, B in distinct.items():
                stack[lab, :, P - p:P + p + 1] = B
        bands.append(stack.contiguous())
    return bands


def plan_scratch(numel: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A run-time plan's scratch, its bytes added to the counter
    ``kron.scratch_bytes`` (``ops/counters.py``)."""
    scratch = torch.empty(numel, dtype=dtype, device=device)
    _count.BYTES["kron.scratch_bytes"] += scratch.numel() \
        * scratch.element_size()
    return scratch


def build_kron_plan(terms, npts, pads, periodic, labels=None,
                    threads_max: int = MAX_THREADS,
                    tcols: Optional[int] = None,
                    trows: Optional[Sequence[int]] = None,
                    widths: Optional[Sequence[int]] = None, cost=None,
                    caps: dict = CAPS,
                    half_widths: Sequence[int] = COMPILED_P,
                    smem=None, what: str = "K1r",
                    scratch_words: int = CAPS["u"] + CAPS["g"],
                    k1r: bool = True,
                    rt_cols: int = 2 * LANES,
                    fold: bool = True) -> KronPlan:
    """Everything a launch needs besides the fields, once per operator.
    ``labels[a][r]`` (default: identity of the band tensors) names the
    sharing; ``threads_max``, ``tcols`` (default: K1's columns per thread
    for the dtype and half-width), ``trows`` (the rows per thread to choose
    among with the tile, default: K1's :func:`rows_options`), ``widths``
    (tile widths offered besides the even ones, default: K1's
    :func:`warp_widths`) and ``cost`` (default: K1's model at each row
    count, or K1r's) shape the tile; ``caps`` bound a launch's partials
    (:func:`chunk_terms`); the bands are padded to the first of
    ``half_widths`` (default: ``COMPILED_P``) that holds them, else the
    plan is the run-time kernel's (``runtime``), at the bands' own
    half-width, and ``smem`` (default: K1r's, :func:`k1r_smem`)
    and ``what`` name its block: on the card a half-width no block of it
    fits raises (:func:`refuse_half_width`; on the CPU such a plan has no
    tiling; ``rt_cols``: the widest pass-A tile, :func:`runtime_tiling`).

    A run-time plan built on the card owns its passes' scratch:
    ``scratch_words`` fields of the arithmetic type (default K1r's: the
    kCU u partials and the kCG pre-summed partials, 4 a point; 42 MB at
    138³ in f32), made here once (:func:`plan_scratch`, which counts it)
    and reused by every launch of the plan, graph replays included.  So
    two launches of one plan must not run at the same time (on two
    streams); the solvers run theirs on one.  Where
    ``k1r`` (the plan is K1r's, not K5r's: ``twofloat.build_kron_df_plan``
    makes K5r's tables itself) its band tables (:func:`k1r_tables`, a few
    hundred KB) are made here too.

    Where ``fold``, terms that share their bands on every axis but one are
    folded first (:func:`fold_terms`; the counter ``kron.folded_terms``
    adds the terms it removed), and the plan's ``terms``, ``labels``,
    ``bands`` and ``cols`` are the folded operator's: the kernel, the plain
    versions of :func:`kron_mode` and :meth:`KronPlan.diagonal` compute it.
    K5's plan passes False: its bands were split into hi and lo words
    before it sees them."""
    npts, pads = tuple(int(n) for n in npts), tuple(int(p) for p in pads)
    periodic = tuple(bool(q) for q in periodic)
    d = len(npts)
    if not 1 <= d <= 3:
        raise NotImplementedError(
            f"Kronecker-sum operators cover 1D/2D/3D fields, got npts={npts}")
    for term in terms:
        if len(term) != d:
            raise ValueError("each term needs one 1D band per dim")
    first = terms[0][0]
    lead = 3 - d
    n3 = (1,) * lead + npts
    pads3 = (0,) * lead + pads
    per3 = (False,) * lead + periodic
    P = _compiled_half_width(pads, half_widths)
    runtime = P not in half_widths
    itemsize = arithmetic_itemsize(first.dtype)
    if smem is None:
        smem = k1r_smem(itemsize)
    if runtime:
        refuse_half_width(pads, first.device, smem, what)
    labels = band_labels(terms) if labels is None else labels
    if fold:
        n_terms = len(terms)
        terms, labels = fold_terms(terms, labels, caps)
        _count.BYTES["kron.folded_terms"] += n_terms - len(terms)
    labels = _lift_labels(labels)
    cols = [torch.ones((len(terms), 1), dtype=first.dtype,
                       device=first.device) for _ in range(lead)]
    cols += [torch.stack([term[a][:, pads[a]] for term in terms]).contiguous()
             for a in range(d)]
    chunks = chunk_terms(labels, caps)
    if tcols is None:
        tcols = 1 if runtime else columns_per_thread(itemsize, P)
    sms = (torch.cuda.get_device_properties(first.device).multi_processor_count
           if first.device.type == "cuda" else SM_COUNT)
    tiling, scratch = None, None
    if not runtime:
        trows, tiling = k1_tiling(
            n3, P, itemsize, threads_max, sms, tcols, trows,
            None if cost is None else lambda R: cost,
            None if widths is None else lambda R: widths)
    elif smem(P, *SMALLEST_BLOCK) <= K2_SMEM:
        cost = k1r_step_cost(itemsize, P) if cost is None else cost
        tiling = runtime_tiling(n3, P, cost, sms, rt_cols)
        if first.device.type == "cuda":
            scratch = plan_scratch(scratch_words * math.prod(n3),
                                   torch.float32 if itemsize == 4
                                   else first.dtype, first.device)
    plan = KronPlan(
        terms=tuple(tuple(term) for term in terms), ndim=d, npts=npts,
        pads=pads, periodic=periodic, n3=n3, per3=per3,
        pads3=pads3, P=P, labels=labels,
        bands=stack_bands(terms, labels, n3, pads3, P), cols=cols,
        chunks=chunks, plans=[sharing_plan(labels, c) for c in chunks],
        tiling=tiling, tcols=tcols, dtype=first.dtype, device=first.device,
        runtime=runtime, trows=1 if trows is None else trows,
        scratch=scratch)
    if scratch is not None and k1r:
        k1r_tables(plan)   # made here, before any graph captures a launch
    return plan


def plan_apply(plan: KronPlan, x_int: torch.Tensor,
               presum: bool = True) -> torch.Tensor:
    """A·x by executing the plan's control data in plain PyTorch: the
    stacked padded bands, the lifted geometry, the runs of terms and each
    run's sharing plan, as the kernel reads them.  ``presum=False`` takes
    the double-word kernel's last stage (one contraction per distinct
    history, the terms added in order)."""
    x3 = x_int.reshape(plan.n3)
    P = plan.P
    total = None
    for sp in plan.plans:
        u = [apply_band_1d_axis(plan.bands[2][lab], x3, 2, P, plan.per3[2])
             for lab in sp["u_lab"]]
        v = [apply_band_1d_axis(plan.bands[1][lab], u[src], 1, P,
                                plan.per3[1])
             for src, lab in zip(sp["v_src"], sp["v_lab"])]
        if presum:
            for lab, mult in zip(sp["g_lab"], sp["g_mult"]):
                w = None
                for k, m in enumerate(mult):
                    if m:
                        w = m * v[k] if w is None else w + m * v[k]
                y = apply_band_1d_axis(plan.bands[0][lab], w, 0, P,
                                       plan.per3[0])
                total = y if total is None else total + y
        else:
            ws = [apply_band_1d_axis(plan.bands[0][lab], v[src], 0, P,
                                     plan.per3[0])
                  for src, lab in zip(sp["w_src"], sp["w_lab"])]
            for k in sp["term_w"]:
                total = ws[k] if total is None else total + ws[k]
    return total.reshape(plan.npts)


def _epilogue(mode, ax, x_int, b, diag, d, c1, c2):
    """The modes' epilogue on A x (``cheb`` returns (x_new, d))."""
    if mode == "apply":
        return ax
    if mode == "residual":
        return b - ax
    if mode == "dinv":
        return ax / diag
    if mode == "cheb":
        z = (b - ax) / diag
        d_new = c2 * z if d is None else c1 * d + c2 * z
        return x_int + d_new, d_new
    raise ValueError(f"unknown kron mode {mode!r}")


def k1r_pass_plain(pass_: str, plan: KronPlan, sp: dict, src,
                   mode: str = "apply", x_int=None, b=None, d=None,
                   c1: float = 0.0, c2: float = 1.0, acc=None, diag=None):
    """Plain PyTorch version of one K1r pass of the run of terms ``sp`` (one
    of ``plan.plans``), on fields of the arithmetic type (a bf16 plan's
    bands are cast to f32 here):

    - ``"A"`` (axis 2): ``src`` the field x → the u partials, one (n3)
      field per ``sp["u_lab"]``;
    - ``"B"`` (axis 1): ``src`` the u partials → the pre-summed partials,
      one per ``sp["g_lab"]``: Σ_k g_mult[g][k]·v_k, v_k = B1·u[v_src[k]];
    - ``"C"`` (axis 0): ``src`` the pre-summed partials → Σ_g B0·w_g onto
      ``acc`` (the earlier runs' A x), then ``mode``'s epilogue (``x_int``,
      ``b``, ``diag``, ``d``, ``c1``, ``c2`` as :func:`kron_mode_plain`).
    """
    P, per = plan.P, plan.per3

    def band(a, lab):
        B = plan.bands[a][lab]
        return B.float() if B.dtype == torch.bfloat16 else B

    if pass_ == "A":
        x3 = src.reshape(plan.n3)
        return [apply_band_1d_axis(band(2, lab), x3, 2, P, per[2])
                for lab in sp["u_lab"]]
    if pass_ == "B":
        v = [apply_band_1d_axis(band(1, lab), src[s], 1, P, per[1])
             for s, lab in zip(sp["v_src"], sp["v_lab"])]
        out = []
        for mult in sp["g_mult"]:
            w = None
            for k, m in enumerate(mult):
                if m:
                    w = m * v[k] if w is None else w + m * v[k]
            out.append(w)
        return out
    if pass_ != "C":
        raise ValueError(f"unknown K1r pass {pass_!r}")
    ax = None
    for lab, w in zip(sp["g_lab"], src):
        y = apply_band_1d_axis(band(0, lab), w, 0, P, per[0])
        ax = y if ax is None else ax + y
    if acc is not None:
        ax = acc.reshape(plan.n3) + ax
    return _epilogue(mode, ax.reshape(plan.npts), x_int, b, diag, d, c1, c2)


def k1r_passes_plain(mode: str, plan: KronPlan, x_int, b=None, d=None,
                     c1: float = 0.0, c2: float = 1.0):
    """K1r's three plain passes chained as the card chains them: per run of
    terms A, B, C, every run but the last adding its A x onto the earlier
    runs' (``apply``), the last applying ``mode``'s epilogue; a bf16 plan
    computes in f32 and rounds each result once."""
    low = x_int.dtype == torch.bfloat16

    def hi(t):
        return None if t is None or not low else t.to(torch.float32)

    if low:
        x_int, b, d = hi(x_int), hi(b), hi(d)
        diag = plan.operands_f32()[1]
    else:
        diag = plan.diagonal()
    acc = None
    for k, sp in enumerate(plan.plans):
        last = k == len(plan.plans) - 1
        u = k1r_pass_plain("A", plan, sp, x_int)
        w = k1r_pass_plain("B", plan, sp, u)
        acc = k1r_pass_plain("C", plan, sp, w, mode if last else "apply",
                             x_int, b, d, c1, c2, acc, diag)
    if low:
        return (tuple(t.to(torch.bfloat16) for t in acc) if mode == "cheb"
                else acc.to(torch.bfloat16))
    return acc


# -- the modes ---------------------------------------------------------------

def kron_mode_plain(mode: str, terms, x_int: torch.Tensor, npts, pads,
                    periodic, b: Optional[torch.Tensor] = None,
                    diag: Optional[torch.Tensor] = None,
                    d: Optional[torch.Tensor] = None, c1: float = 0.0,
                    c2: float = 1.0):
    """Plain PyTorch version of every mode (``cheb`` returns (x_new, d))."""
    if mode not in MODES:
        raise ValueError(f"unknown kron mode {mode!r}")
    ax = kron_apply_plain(terms, x_int, npts, pads, periodic)
    return _epilogue(mode, ax, x_int, b, diag, d, c1, c2)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("kron_apply")
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = [ptr] * 13 + [f64, f64, i32, ptr, ptr, ptr, ptr]
        f.restype = i32
    for fn in _KERNELS_RT.values():   # K1r: the pass first; scratch, table
        f = getattr(lib, fn)
        f.argtypes = [i32] + [ptr] * 13 + [f64, f64, i32] + [ptr] * 6
        f.restype = i32
    lib.kron_apply_resources.argtypes = [i32, i32, i32, ptr, ptr]
    lib.kron_apply_resources.restype = i32
    lib.kron_apply_error_string.argtypes = [i32]
    lib.kron_apply_error_string.restype = ctypes.c_char_p
    return lib


def _geometry_ints(plan: KronPlan, tiling) -> list:
    if plan.runtime:   # K1r: (TL, warps of passes A, B, C)
        TL, wa, wb, wc = tiling
        return [*plan.n3, *(int(q) for q in plan.per3), plan.P,
                plan.n_terms, TL, (LANES * wa) // (TL // 2), wb, wc]
    T1, T2, chunk = tiling
    threads = 32 * math.ceil(T1 // plan.trows * (T2 // plan.tcols) / 32)
    return [*plan.n3, *(int(q) for q in plan.per3), plan.P, T1, T2, chunk,
            threads, plan.n_terms, plan.trows]


def _plan_ints(sp: dict) -> list:
    """One run's sharing plan in the kernel's fixed layout."""
    caps = CAPS
    def padded(xs, n):
        return list(xs) + [0] * (n - len(xs))

    mult = [padded(row, caps["v"]) for row in sp["g_mult"]]
    mult += [[0] * caps["v"]] * (caps["g"] - len(mult))
    return ([len(sp["u_lab"]), len(sp["v_src"]), len(sp["g_lab"])]
            + padded(sp["u_lab"], caps["u"]) + padded(sp["v_src"], caps["v"])
            + padded(sp["v_lab"], caps["v"]) + padded(sp["g_lab"], caps["g"])
            + [m for row in mult for m in row])


def _c_args(plan: KronPlan):
    """ctypes int arrays of the geometry and of each run's plan, built at
    the first launch and kept on the plan."""
    if not plan._cargs:
        geo = _geometry_ints(plan, plan.tiling)
        plan._cargs = [(ctypes.c_int * len(geo))(*geo)] + [
            (ctypes.c_int * len(ints))(*ints)
            for ints in map(_plan_ints, plan.plans)]
    return plan._cargs


def _check(plan: KronPlan, x_int, others):
    if x_int.dtype not in _KERNELS:
        raise TypeError(f"the kron_apply kernel takes float32, float64 or "
                        f"bfloat16, got {x_int.dtype}")
    if tuple(x_int.shape) != plan.npts:
        raise ValueError(f"x has shape {tuple(x_int.shape)}, expected "
                         f"{plan.npts}")
    if x_int.dtype != plan.dtype or x_int.device != plan.device:
        raise ValueError("bands and x must share device and dtype")
    for name, t in others:
        if t is None:
            continue
        if tuple(t.shape) != plan.npts:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{plan.npts}")
        if t.dtype != x_int.dtype or t.device != x_int.device:
            raise ValueError(f"{name} and x must share device and dtype")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kron_mode(mode: str, plan: KronPlan, x_int: torch.Tensor,
              b: Optional[torch.Tensor] = None,
              d: Optional[torch.Tensor] = None, c1: float = 0.0,
              c2: float = 1.0, out: Optional[torch.Tensor] = None,
              tiling=None):
    """One K1 pass in ``mode`` (see the module docstring) over the unpadded
    interior field ``x_int`` (any strides).

    ``b``: the right-hand side (``residual``, ``cheb``); ``d``: the
    Chebyshev direction, updated in place on the card (``None``: the first
    step, d = c2·z); ``out``: a buffer for the result (not ``x_int``, whose
    neighbours are still read).  ``cheb`` returns ``(x_new, d)``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``tiling`` overrides the plan's (T1, T2, chunk), for tuning.
    """
    if mode not in MODES:
        raise ValueError(f"unknown kron mode {mode!r}")
    if (mode in ("residual", "cheb")) != (b is not None):
        raise ValueError(f"mode {mode!r} {'needs' if b is None else 'takes no'}"
                         " b")
    if x_int.device.type == "cpu":
        if x_int.dtype == torch.bfloat16:
            return kron_mode_plain_bf16(mode, plan, x_int, b, d, c1, c2)
        diag = plan.diagonal() if mode in ("dinv", "cheb") else None
        return kron_mode_plain(mode, plan.terms, x_int, plan.npts, plan.pads,
                               plan.periodic, b, diag, d, c1, c2)
    if x_int.device.type != "cuda":
        raise NotImplementedError(f"kron_apply on {x_int.device.type} tensors")
    with torch.cuda.device(x_int.device):
        return _launch(mode, plan, x_int, b, d, c1, c2, out, tiling,
                       torch.cuda.current_stream().cuda_stream)


def kron_mode_plain_bf16(mode, plan: KronPlan, x_int, b, d, c1, c2):
    """The bf16 kernel's plain version: every operand cast to f32, the f32
    expressions of :func:`kron_mode_plain`, each result rounded once."""
    def hi(t):
        return None if t is None else t.to(torch.float32)

    terms, diag = plan.operands_f32()
    res = kron_mode_plain(mode, terms, hi(x_int), plan.npts, plan.pads,
                          plan.periodic, hi(b), diag, hi(d), c1, c2)
    if mode == "cheb":
        return tuple(t.to(torch.bfloat16) for t in res)
    return res.to(torch.bfloat16)


def _launch(mode, plan: KronPlan, x_int, b, d, c1, c2, out, tiling, stream):
    """Check the operands, allocate the results and launch one kernel per
    run of terms on ``stream``."""
    _check(plan, x_int, (("b", b), ("d", d), ("out", out)))
    if b is not None:
        b = b.contiguous()
    if d is not None and not d.is_contiguous():
        raise ValueError("d is updated in place and must be contiguous")
    if out is None:
        out = torch.empty(plan.npts, dtype=x_int.dtype, device=x_int.device)
    elif not out.is_contiguous() or out.data_ptr() == x_int.data_ptr():
        raise ValueError("out must be a contiguous buffer other than x")
    d_out = d
    if mode == "cheb" and d is None:
        d_out = torch.empty_like(out)
    x3 = x_int.reshape(plan.n3) if x_int.ndim != 3 else x_int
    # a bf16 operator's sum between launches stays f32 (``out_hi``)
    wide = x_int.dtype == torch.bfloat16
    if plan.runtime:
        return _launch_rt(mode, plan, x3, b, d, d_out, out, c1, c2, tiling,
                          wide, stream)
    strides = (ctypes.c_int64 * 3)(*x3.stride())
    geo, *runs = _c_args(plan)
    if tiling is not None:
        ints = _geometry_ints(plan, tiling)
        geo = (ctypes.c_int * len(ints))(*ints)
    lib = _library()
    fn = getattr(lib, _KERNELS[x_int.dtype])
    bands = [t.data_ptr() for t in plan.bands]
    cols = [t.data_ptr() for t in plan.cols]
    acc = None
    for k, (run, target) in enumerate(zip(runs,
                                          _runs_targets(plan, out, wide))):
        last = k == len(runs) - 1
        # every run but the last adds its terms' A·x to ``acc``; the last
        # one applies the mode's epilogue to the whole sum
        run_mode = mode if last else "apply"
        as_hi = wide and not last
        err = fn(x3.data_ptr(), *bands, *cols, _ptr(acc),
                 _ptr(b) if last else None, _ptr(d) if last else None,
                 _ptr(d_out) if last and mode == "cheb" else None,
                 None if as_hi else target.data_ptr(),
                 target.data_ptr() if as_hi else None, float(c1), float(c2),
                 MODES.index(run_mode), strides, geo, run, stream)
        if err != 0:
            raise RuntimeError(
                f"kron_apply kernel launch failed ({run_mode}): "
                + lib.kron_apply_error_string(err).decode())
        _count.count(kron_mode, x_int.dtype, run_mode)
        if run_mode == "apply":
            kron_apply.launches += 1
        if not last:
            _count_partial(target)
        acc = target
    if mode == "cheb":
        return out, d_out
    return out


def _runs_targets(plan: KronPlan, out, wide: bool):
    """The buffer each run of terms writes: a fresh one (f32 for a bf16
    operator: ``out_hi``) for every run but the last, ``out`` for it."""
    n = len(plan.plans)
    return [out if k == n - 1 else torch.empty(
        plan.npts, device=out.device,
        dtype=torch.float32 if wide else out.dtype) for k in range(n)]


def _count_partial(acc: torch.Tensor) -> None:
    """``kron.partial_bytes``: the partial sum ``acc`` that a run of terms
    but the last writes and the next run reads back, once each."""
    _count.BYTES["kron.partial_bytes"] += 2 * acc.numel() * acc.element_size()


def strided_table(bands_a, labs, kmax: int, NW: int, P: int,
                  dtype) -> torch.Tensor:
    """K1r's band table of a strided pass (B on axis 1, C on axis 0) of one
    run of terms, as each block's shared memory holds it: per block of
    ``NW``·RT_OUT outputs along the axis one slice (kmax, NW, RT_OUT + 2P,
    RT_OUT), the entry [.., k, grp, p, r] the coefficient of a thread's
    input row p for its output r (tap p − r of band row grp·RT_OUT + r of
    the block), zero off the band, past the grid and for k ≥ len(labs)."""
    n_a, W, R = bands_a.shape[1], 2 * P + 1, RT_OUT
    dev = bands_a.device
    nb = math.ceil(n_a / (NW * R))

    def ar(n):
        return torch.arange(n, device=dev)

    a = (ar(nb)[:, None, None, None] * NW * R
         + ar(NW)[None, :, None, None] * R + ar(R)[None, None, None, :])
    t = ar(R + 2 * P)[None, None, :, None] - ar(R)[None, None, None, :]
    valid = (t >= 0) & (t < W) & (a < n_a)
    a, t = a.clamp(max=n_a - 1), t.clamp(0, W - 1)
    out = torch.zeros((nb, kmax, NW, R + 2 * P, R), dtype=dtype, device=dev)
    for k, lab in enumerate(labs):
        out[:, k] = torch.where(valid, bands_a[lab].to(dtype)[a, t], 0)
    return out.contiguous()


def column_table(bands2, labs, kmax: int, TL: int, dtype,
                 lo=None) -> torch.Tensor:
    """The band table of pass A (axis 2) of one run of terms: per tile of
    ``TL`` columns one slice (kmax, 2P + 1, TL), (k, tap, column), zero
    past the grid and for k ≥ len(labs); with ``lo`` (K5r) hi then lo,
    (tiles, 2, kmax, 2P + 1, TL)."""
    n2, W = bands2.shape[1], bands2.shape[2]
    nt = math.ceil(n2 / TL)
    dev = bands2.device
    lcol = (torch.arange(nt, device=dev)[:, None, None] * TL
            + torch.arange(TL, device=dev)[None, None, :])
    t = torch.arange(W, device=dev)[None, :, None]
    valid = lcol < n2
    lcol = lcol.clamp(max=n2 - 1)
    sources = [bands2] if lo is None else [bands2, lo]
    out = torch.zeros((nt, len(sources), kmax, W, TL), dtype=dtype,
                      device=dev)
    for h, src in enumerate(sources):
        for k, lab in enumerate(labs):
            out[:, h, k] = torch.where(valid, src[lab].to(dtype)[lcol, t], 0)
    return (out[:, 0] if lo is None else out).contiguous()


def k1r_tables(plan: KronPlan, tiling=None) -> list:
    """K1r's band tables of ``tiling`` (default the plan's), per run of
    terms the tables of passes A, B and C in the arithmetic type
    (:func:`column_table`, :func:`strided_table`), made on the plan's
    device once per launch shape and kept on the plan."""
    tiling = tuple(plan.tiling if tiling is None else tiling)
    if tiling not in plan._tables:
        TL, _, wb, wc = tiling
        dtype = (torch.float64 if plan.dtype == torch.float64
                 else torch.float32)
        plan._tables[tiling] = [
            (column_table(plan.bands[2], sp["u_lab"], CAPS["u"], TL, dtype),
             strided_table(plan.bands[1], sp["v_lab"], CAPS["v"], wb,
                           plan.P, dtype),
             strided_table(plan.bands[0], sp["g_lab"], CAPS["g"], wc,
                           plan.P, dtype))
            for sp in plan.plans]
    return plan._tables[tiling]


def k1r_launch_pass(pass_: str, plan: KronPlan, run: int, x3, mode="apply",
                    acc=None, b=None, d=None, d_out=None, out=None,
                    out_hi=None, c1=0.0, c2=1.0, stream=None, tiling=None):
    """Launch one K1r pass (``"A"``, ``"B"`` or ``"C"``) of run ``run`` of
    ``plan`` on ``stream`` (default: the current one) and count it: A reads
    ``x3`` and writes the u partials into ``plan.scratch``, B reads them
    and writes the pre-summed partials there, C reads those (and ``acc``,
    ``b``, ``d``, ``x3``) and writes ``out`` (``out_hi``, ``d_out``) in
    ``mode`` (:func:`k1r_scratch_fields` views the scratch)."""
    geo, *runs = _c_args(plan)
    if tiling is not None:
        ints = _geometry_ints(plan, tiling)
        geo = (ctypes.c_int * len(ints))(*ints)
    if stream is None:
        stream = torch.cuda.current_stream(x3.device).cuda_stream
    strides = (ctypes.c_int64 * 3)(*x3.stride())
    lib = _library()
    fn = getattr(lib, _KERNELS_RT[x3.dtype])
    table = k1r_tables(plan, tiling)[run][RT_PASSES.index(pass_)]
    err = fn(RT_PASSES.index(pass_), x3.data_ptr(),
             *(t.data_ptr() for t in plan.bands),
             *(t.data_ptr() for t in plan.cols), _ptr(acc), _ptr(b), _ptr(d),
             _ptr(d_out), _ptr(out), _ptr(out_hi), float(c1), float(c2),
             MODES.index(mode), strides, geo, runs[run],
             plan.scratch.data_ptr(), table.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"kron_apply K1r pass {pass_} launch failed ({mode}): "
            + lib.kron_apply_error_string(err).decode())
    _count.count(kron_mode, x3.dtype, mode)
    _count.count(kron_mode.runtime, x3.dtype, f"{mode}.{pass_}")
    if mode == "apply":
        kron_apply.launches += 1


def k1r_scratch_fields(plan: KronPlan):
    """(u, w): a K1r plan's scratch as the kCU u partials and the kCG
    pre-summed partials, each an (n0, n1, n2) field."""
    f = plan.scratch.view(-1, *plan.n3)
    return list(f[:CAPS["u"]]), list(f[CAPS["u"]:CAPS["u"] + CAPS["g"]])


def _launch_rt(mode, plan: KronPlan, x3, b, d, d_out, out, c1, c2, tiling,
               wide, stream):
    """K1r: per run of terms its three passes through the plan's scratch,
    every run but the last adding its A x onto ``acc``."""
    if plan.scratch is None:
        raise RuntimeError("this K1r plan was built off the card: it has no "
                           "scratch")
    acc = None
    targets = _runs_targets(plan, out, wide)
    for k, target in enumerate(targets):
        last = k == len(targets) - 1
        as_hi = wide and not last
        for pass_ in RT_PASSES:
            k1r_launch_pass(
                pass_, plan, k, x3, mode if last else "apply", acc=acc,
                b=b if last else None, d=d if last else None,
                d_out=d_out if last and mode == "cheb" else None,
                out=None if as_hi else target,
                out_hi=target if as_hi else None, c1=c1, c2=c2,
                stream=stream, tiling=tiling)
        if not last:
            _count_partial(target)
        acc = target
    if mode == "cheb":
        return out, d_out
    return out


_count.attach(kron_mode, MODES)
kron_mode.runtime = SimpleNamespace()   # K1r's launches, per mode and pass
_count.attach(kron_mode.runtime, [f"{m}.{p}" for m in MODES
                                  for p in RT_PASSES])


def k1_resources(plan: KronPlan, mode: str = "cheb") -> dict:
    """What K1's launch of ``plan`` in ``mode`` gets on the card: registers
    and local memory (spilled registers) a thread, shared memory a block,
    blocks an SM holds at once, threads a block.  For K1r the same of each
    pass under ``passes`` (A, B, C), and at the top level the most
    registers, local memory, shared memory and threads and the fewest
    blocks an SM of the three."""
    geo = _c_args(plan)[0]
    lib = _library()

    def query(pass_):
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(plan.device):
            err = lib.kron_apply_resources(
                list(_KERNELS).index(plan.dtype), MODES.index(mode), pass_,
                geo, out)
        if err != 0:
            raise RuntimeError("k1_resources: "
                               + lib.kron_apply_error_string(err).decode())
        return {"registers": out[0], "local_bytes": out[1],
                "smem_bytes": out[2], "blocks_per_sm": out[3]}

    if not plan.runtime:
        return {**query(-1), "threads": geo[10]}
    TL, wa, wb, wc = plan.tiling
    passes = {p: {**query(i), "threads": LANES * w}
              for i, (p, w) in enumerate(zip(RT_PASSES, (wa, wb, wc)))}
    passes["A"]["threads"] = LANES * math.ceil(
        TL // 2 * ((LANES * wa) // (TL // 2)) / LANES)
    return {**{k: max(r[k] for r in passes.values())
               for k in ("registers", "local_bytes", "smem_bytes",
                         "threads")},
            "blocks_per_sm": min(r["blocks_per_sm"] for r in passes.values()),
            "passes": passes}


def kron_apply(terms: Sequence[Sequence[torch.Tensor]], x_int: torch.Tensor,
               npts, pads, periodic) -> torch.Tensor:
    """y = (Σ_r ⊗_a B_r^(a)) x for interior field ``x_int``.

    ``terms``: per term, one (n_a, 2p_a+1) band per axis.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.  The launch
    data is built here, per call: an operator keeps its own
    (:func:`build_kron_plan`) and calls :func:`kron_mode`.
    """
    npts, pads, periodic = tuple(npts), tuple(pads), tuple(periodic)
    if x_int.device.type == "cpu":
        if x_int.dtype == torch.bfloat16:   # in f32, rounded once
            cast = {}
            hi = [[cast.setdefault(id(B), B.to(torch.float32)) for B in term]
                  for term in terms]
            return kron_apply_plain(hi, x_int.to(torch.float32), npts, pads,
                                    periodic).to(torch.bfloat16)
        return kron_apply_plain(terms, x_int, npts, pads, periodic)
    if x_int.device.type != "cuda":
        raise NotImplementedError(f"kron_apply on {x_int.device.type} tensors")
    _check_terms(terms, x_int, npts, pads)
    return kron_mode("apply", build_kron_plan(terms, npts, pads, periodic),
                     x_int)


def _check_terms(terms, x_int: torch.Tensor, npts, pads):
    if x_int.dtype not in _KERNELS:
        raise TypeError(f"the kron_apply kernel takes float32, float64 or "
                        f"bfloat16, got {x_int.dtype}")
    if tuple(x_int.shape) != tuple(npts):
        raise ValueError(f"x has shape {tuple(x_int.shape)}, expected "
                         f"{tuple(npts)}")
    for term in terms:
        if len(term) != len(npts):
            raise ValueError("each term needs one 1D band per dim")
        for a, B in enumerate(term):
            if tuple(B.shape) != (npts[a], 2 * pads[a] + 1):
                raise ValueError(f"band {a} has shape {tuple(B.shape)}, "
                                 f"expected {(npts[a], 2 * pads[a] + 1)}")
            if B.device != x_int.device or B.dtype != x_int.dtype:
                raise ValueError("bands and x must share device and dtype")


kron_apply.launches = 0
