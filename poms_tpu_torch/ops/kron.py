"""K1: the fused Kronecker-sum apply y = Σ_r (B_r⁽⁰⁾ ⊗ B_r⁽¹⁾ ⊗ B_r⁽²⁾)·x and
its residual, D⁻¹ and Chebyshev epilogues.

Counterpart of ``poms_tpu/ops/pallas/kron.py::kron_apply_pallas``.
:func:`kron_mode` runs one pass over an unpadded interior field in one of

- ``apply``:    y = A x
- ``residual``: r = b − A x
- ``dinv``:     y = (A x) / diag(A)
- ``cheb``:     z = (b − A x) / diag(A); d ← c1·d + c2·z; x_new = x + d

For a CUDA tensor it launches the hand-written kernel of
``csrc/kron_apply.cu`` (f32, f64 or bf16; 1D and 2D lifted to 3D) or raises;
for a CPU tensor it runs :func:`kron_mode_plain`, built on the shared-partial
chain of 1D axis contractions of ``poms_tpu/core/kron.py::_apply_interior``
(:func:`kron_apply_plain`).  ``kron_mode.launches[mode]`` counts kernel
launches per mode (``launches_by_dtype[name][mode]`` those of one
instantiation) and ``kron_apply.launches`` those of ``apply``.

A bf16 operator (bf16 bands and fields) is computed in f32 and rounded once
per output value, by the kernel and by the plain version alike
(:func:`kron_mode` casts the operands up, runs the f32 expressions and
rounds); the JAX package's Pallas kernel is f32 only and its bf16 cycle goes
through XLA in bf16, so the port's is at least as exact and not bitwise with
it.

What the kernel needs beyond the field is built once per operator by
:func:`build_kron_plan`: the distinct bands of each axis stacked and
zero-padded to one compiled half-width, the centre columns for the in-kernel
diagonal, the **sharing plan** (which (partial, band) pairs each axis
contracts, and which partials are summed before the last contraction) as
small integer arrays, and the tiling.  :func:`plan_apply` executes the same
control data in plain PyTorch, so it is tested where no card is.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.ops import _build, _count

__all__ = ["MODES", "kron_apply", "kron_apply_plain", "kron_mode",
           "kron_mode_plain", "kron_mode_plain_bf16", "apply_band_1d_axis",
           "band_labels",
           "sharing_plan", "chunk_terms", "build_kron_plan", "plan_apply",
           "diagonal_from_columns", "kron_tiling", "k1_step_cost", "KronPlan",
           "stack_bands", "refuse_half_width", "COMPILED_P"]

MODES = ("apply", "residual", "dinv", "cheb")
_KERNELS = {torch.float32: "kron_apply_f32", torch.float64: "kron_apply_f64",
            torch.bfloat16: "kron_apply_bf16"}
# mirrored in csrc/kron_apply.cu (kCU, kCV, kCG, the instantiated half-widths,
# kMaxThreads, columns and min_blocks): partials one launch may hold per axis,
# compiled P (every dtype: spline degrees 1-8 run on the card, 4 on 5, 6 and
# 7 on 8; K5 has its own, ops/twofloat.py::COMPILED_P_DW)
CAPS = {"u": 2, "v": 3, "g": 2}
COMPILED_P = (1, 2, 3, 5, 8)
SM_COUNT = 132   # H100 SXM: the tiling's cost model where no card is asked
MAX_THREADS = 256         # block size limit


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


def k1_step_cost(itemsize: int, P: int):
    """K1's cost model for :func:`kron_tiling`, in µs, fitted to a sweep of
    tilings at 129³, 65³, 33³ and 17³ (p = 3, f32) on an H100: a plane step
    costs 1 µs (two barriers and a chain of short phases) plus 1.5 ns per
    thread resident on the SM (×1.6 where the axis-2 pass needs a second
    round for the halo rows), a block 2 µs to start; two blocks share an SM
    where 128 registers a thread suffice (f32, P ≤ 3)."""
    threads_per_sm = 512 if columns_per_thread(itemsize, P) == 2 else 256

    def cost(T1, T2, threads, chunk, blocks, sms):
        per_sm = max(1, threads_per_sm // threads)
        waves = math.ceil(blocks / (sms * per_sm))
        resident = min(per_sm, math.ceil(blocks / waves / sms))
        rounds = math.ceil((T1 + 2 * P) / T1)
        step = 1.0 + (0.0015 * threads * resident * (1 + 0.6 * (rounds - 1))
                      * (2 * P + 1) / 7)
        return waves * (2.0 + (chunk + 2 * P) * step)

    return cost


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


def kron_tiling(n3, P: int, threads_max: int, cost, sms: int = SM_COUNT,
                cols: int = 1):
    """(T1, T2, chunk): a block owns a T1 × T2 column of the (axis 1,
    axis 2) grid and marches over ``chunk`` output planes of axis 0; a
    thread owns ``cols`` neighbouring columns (T2 is a multiple of it).

    Tiles divide each axis evenly (a 2^k+1 grid gets no nearly empty last
    tile).  Among tile widths of 16 to 64 columns, three block sizes and up
    to 64 runs of planes, the one with the least modelled time is taken:
    ``cost(T1, T2, threads, chunk, blocks, sms)`` is the kernel's own model
    (K1's: :func:`k1_step_cost`), infinite for a block that does not fit.
    Splitting axis 0 adds 2P halo planes per run but fills the SMs at small
    grids.
    """
    n0, n1, n2 = n3
    best = None
    t2_cap = threads_max * cols if n1 == 1 else 64
    k2_min = math.ceil(n2 / t2_cap)
    for k2 in range(k2_min, min(n2, k2_min + 63) + 1):
        T2 = cols * math.ceil(n2 / k2 / cols)
        if T2 < min(16, n2):
            break
        for budget in (threads_max, threads_max // 2, threads_max // 4):
            if budget < T2 // cols:
                continue
            k1 = math.ceil(n1 / (budget // (T2 // cols)))
            T1 = math.ceil(n1 / k1)
            threads = 32 * math.ceil(T1 * (T2 // cols) / 32)
            for nchunks in range(1, min(n0, 64) + 1):
                chunk = math.ceil(n0 / nchunks)
                if math.ceil(n0 / chunk) != nchunks:
                    continue
                c = cost(T1, T2, threads, chunk, k1 * k2 * nchunks, sms)
                if best is None or c < best[0]:
                    best = (c, T1, T2, chunk)
    if best is None or math.isinf(best[0]):
        raise ValueError(f"no tiling of {n3} at half-width {P} fits a block")
    return best[1:]


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
    tiling: Tuple[int, int, int]
    tcols: int                    # tile columns per thread
    dtype: torch.dtype
    device: torch.device
    bands_lo: Optional[List[torch.Tensor]] = None   # K5: the lo words
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
    p = max(max(pads), 1)
    for P in half_widths:
        if P >= p:
            return P
    return p   # no instantiation: a plan on the card is refused


def refuse_half_width(pads, device: torch.device):
    """On the card, raise for bands wider than every compiled half-width
    (a spline degree above 8): no kernel takes them, and none falls back
    to the plain version."""
    p = max(pads)
    if device.type == "cuda" and p > COMPILED_P[-1]:
        raise RuntimeError(
            f"the Kronecker-sum kernels take half-widths up to "
            f"{COMPILED_P[-1]} (spline degrees 1-{COMPILED_P[-1]}: K1 is "
            f"compiled for half-widths {COMPILED_P}, K5 for each of 1-"
            f"{COMPILED_P[-1]}); this operator has bands of half-width {p} "
            f"(degree {p})")


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


def build_kron_plan(terms, npts, pads, periodic, labels=None,
                    threads_max: int = MAX_THREADS,
                    tcols: Optional[int] = None, cost=None,
                    caps: dict = CAPS,
                    half_widths: Sequence[int] = COMPILED_P) -> KronPlan:
    """Everything a launch needs besides the fields, once per operator.
    ``labels[a][r]`` (default: identity of the band tensors) names the
    sharing; ``threads_max``, ``tcols`` (default: K1's columns per thread
    for the dtype and half-width) and ``cost`` (default: K1's model) shape
    the tile; ``caps`` bound a launch's partials (:func:`chunk_terms`);
    the bands are padded to the first of ``half_widths`` that holds them.
    On the card, bands above the widest compiled half-width raise."""
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
    refuse_half_width(pads, first.device)
    lead = 3 - d
    n3 = (1,) * lead + npts
    pads3 = (0,) * lead + pads
    per3 = (False,) * lead + periodic
    P = _compiled_half_width(pads, half_widths)
    labels = _lift_labels(band_labels(terms) if labels is None else labels)
    cols = [torch.ones((len(terms), 1), dtype=first.dtype,
                       device=first.device) for _ in range(lead)]
    cols += [torch.stack([term[a][:, pads[a]] for term in terms]).contiguous()
             for a in range(d)]
    chunks = chunk_terms(labels, caps)
    itemsize = arithmetic_itemsize(first.dtype)
    if tcols is None:
        tcols = columns_per_thread(itemsize, P)
    if cost is None:
        cost = k1_step_cost(itemsize, P)
    sms = (torch.cuda.get_device_properties(first.device).multi_processor_count
           if first.device.type == "cuda" else SM_COUNT)
    return KronPlan(
        terms=tuple(tuple(term) for term in terms), ndim=d, npts=npts,
        pads=pads, periodic=periodic, n3=n3, per3=per3,
        pads3=pads3, P=P, labels=labels,
        bands=stack_bands(terms, labels, n3, pads3, P), cols=cols,
        chunks=chunks, plans=[sharing_plan(labels, c) for c in chunks],
        tiling=kron_tiling(n3, P, threads_max, cost, sms, tcols), tcols=tcols,
        dtype=first.dtype, device=first.device)


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


# -- the modes ---------------------------------------------------------------

def kron_mode_plain(mode: str, terms, x_int: torch.Tensor, npts, pads,
                    periodic, b: Optional[torch.Tensor] = None,
                    diag: Optional[torch.Tensor] = None,
                    d: Optional[torch.Tensor] = None, c1: float = 0.0,
                    c2: float = 1.0):
    """Plain PyTorch version of every mode (``cheb`` returns (x_new, d))."""
    ax = kron_apply_plain(terms, x_int, npts, pads, periodic)
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


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("kron_apply")
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = [ptr] * 13 + [f64, f64, i32, ptr, ptr, ptr, ptr]
        f.restype = i32
    lib.kron_apply_error_string.argtypes = [i32]
    lib.kron_apply_error_string.restype = ctypes.c_char_p
    return lib


def _geometry_ints(plan: KronPlan, tiling) -> list:
    T1, T2, chunk = tiling
    threads = 32 * math.ceil(T1 * (T2 // plan.tcols) / 32)
    return [*plan.n3, *(int(q) for q in plan.per3), plan.P, T1, T2, chunk,
            threads, plan.n_terms]


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
    strides = (ctypes.c_int64 * 3)(*x3.stride())
    geo, *runs = _c_args(plan)
    if tiling is not None:
        ints = _geometry_ints(plan, tiling)
        geo = (ctypes.c_int * len(ints))(*ints)
    lib = _library()
    fn = getattr(lib, _KERNELS[x_int.dtype])
    bands = [t.data_ptr() for t in plan.bands]
    cols = [t.data_ptr() for t in plan.cols]
    # a bf16 operator's sum between launches stays f32 (``out_hi``)
    wide = x_int.dtype == torch.bfloat16
    acc = None
    for k, run in enumerate(runs):
        last = k == len(runs) - 1
        # every run but the last adds its terms' A·x to ``acc``; the last
        # one applies the mode's epilogue to the whole sum
        run_mode = mode if last else "apply"
        if last:
            target = out
        else:
            target = torch.empty(plan.npts, device=out.device,
                                 dtype=torch.float32 if wide else out.dtype)
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
        acc = target
    if mode == "cheb":
        return out, d_out
    return out


_count.attach(kron_mode, MODES)


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
