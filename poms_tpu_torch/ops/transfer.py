"""Restriction / prolongation application — banded per-axis gathers.

Counterpart of ``poms_tpu.ops.transfer``: a tensor-product transfer
P = ⊗_a P_1^(a) is applied one axis at a time, each 1D application being

    y[..., i, ...] = Σ_t  w[i, t] · x[..., (c0[i] + t) mod n_in, ...]

A periodic transfer has rows whose nonzeros wrap around the end of the
axis.  The JAX package bands such a matrix as wide as the axis (W = n_in,
zeros between); here :func:`bands_from_dense` returns the narrowest cyclic
band instead (``wrap=True``: W = p + 2 for the restriction, ⌈(p+2)/2⌉ for
the prolongation) and a wrapped row adds its taps in ascending column order,
which is the order of the W = n_in evaluation without its zero taps.  A zero
tap adds exactly, so both give the same bits, up to the sign of a zero.

K7: for CUDA tensors :func:`apply_transfer` launches the hand-written kernel
of ``csrc/transfer.cu`` once per transfer, every axis in it (or raises); for
CPU tensors it runs :func:`apply_transfer_plain`.  The kernel adds the taps
in the plain version's order with multiplies and adds the compiler may not
fuse, so its result equals the plain version's bit for bit.
``apply_transfer.launches`` counts kernel launches (``launches_by_dtype[name]``
those of one instantiation).  f32, f64 and bf16: in bf16 weights and fields
are bf16, each axis' taps are multiplied and added in f32 (with the addend,
in the last axis) and rounded to bf16, in the kernel and in the plain version
alike.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from poms_tpu_torch.core.space import resolve_device
from poms_tpu_torch.ops import _build, _count

__all__ = ["TransferBand", "bands_from_dense", "apply_transfer_axis",
           "apply_transfer", "apply_transfer_plain", "transfer_tiling"]

# the kernel's dtype codes (csrc/transfer.cu::transfer_apply)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
SM_COUNT = 132                 # H100 SXM: the tiling where no card is asked
SMEM_LIMIT = 227 * 1024        # shared memory a block may opt into


@dataclass
class TransferBand:
    """Banded 1D transfer: out[i] = Σ_t w[i, t] * x[(c0[i] + t) mod n_in].

    ``w`` (n_out, W); ``c0`` (n_out,) int64.  Unwrapped (the JAX package's
    form): c0 is clipped so that c0[i] + W <= n_in, with zero weights
    padding the clipped rows, and the taps are added for t = 0, 1, ...
    ``wrap``: a row may run past the end of the axis, and its taps are
    added in ascending column order (those past the end first).
    Set from these: ``step``, the largest cyclic advance of c0 from one
    row to the next, which bounds the input rows a run of outputs reads;
    ``cols`` and ``tap_w`` (n_out, W), the column and the weight of each
    tap in the order the taps are added (:func:`_taps`), which the plain
    version and the kernel both read.
    """
    w: torch.Tensor
    c0: torch.Tensor
    n_in: int
    wrap: bool = False
    step: int = field(init=False, repr=False, compare=False)
    cols: torch.Tensor = field(init=False, repr=False, compare=False)
    tap_w: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        c0 = self.c0.detach().cpu().numpy().astype(np.int64)
        self.step = int(np.mod(np.diff(c0), self.n_in).max()) \
            if c0.size > 1 else 0
        self.cols, self.tap_w = _taps(self)

    @property
    def n_out(self) -> int:
        return self.w.shape[0]

    @property
    def width(self) -> int:
        return self.w.shape[1]


def _cyclic_arc(cols: np.ndarray, n: int) -> Tuple[int, int]:
    """(start, width) of the shortest cyclic run of ``n`` columns holding
    the sorted columns ``cols``: it begins after the widest gap."""
    if cols.size == 0:
        return 0, 0
    gaps = np.diff(np.append(cols, cols[0] + n))
    k = int(gaps.argmax())
    return int(cols[(k + 1) % cols.size]), n - int(gaps[k]) + 1


def bands_from_dense(P: np.ndarray, dtype=torch.float64,
                     device=None) -> TransferBand:
    """Extract the banded form of a dense (n_out, n_in) transfer matrix
    (``device=None``: the current CUDA card, an error when there is none):
    the narrowest cyclic band (``wrap=True``) where rows wrap around the end
    of the axis and that is narrower than the plain band, else the plain
    band of the JAX package's ``bands_from_dense``."""
    device = resolve_device(device)
    P = np.asarray(P)
    n_out, n_in = P.shape
    nz = np.abs(P) > 0.0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    W = int((last - first + 1).max())
    W = min(W, n_in)
    c0 = np.minimum(first, n_in - W).astype(np.int64)
    arcs = [_cyclic_arc(np.flatnonzero(row), n_in) for row in nz]
    wrap = max(width for _, width in arcs) < W
    if wrap:
        W = max(width for _, width in arcs)
        c0 = np.array([start for start, _ in arcs], dtype=np.int64)
    cols = (c0[:, None] + np.arange(W)) % n_in
    w = P[np.arange(n_out)[:, None], cols]
    return TransferBand(w=torch.as_tensor(w, dtype=dtype, device=device),
                        c0=torch.as_tensor(c0, device=device), n_in=n_in,
                        wrap=wrap)


def _taps(tb: TransferBand):
    """(cols, w), each (n_out, W): the k-th term row i adds is
    w[i, k] · x[cols[i, k]], in the order the kernel adds them (a wrapped
    row from its first tap past the end of the axis)."""
    t = torch.arange(tb.width, device=tb.c0.device)
    start = torch.zeros_like(tb.c0)
    if tb.wrap:
        start = torch.where(tb.c0 + tb.width > tb.n_in, tb.n_in - tb.c0, 0)
    t = (start[:, None] + t) % tb.width
    return (tb.c0[:, None] + t) % tb.n_in, tb.w.gather(1, t)


def apply_transfer_axis(tb: TransferBand, x: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """Apply a 1D banded transfer along one axis of a d-D interior array,
    in x's dtype (the weights cast to it)."""
    bshape = [1] * x.ndim
    bshape[axis] = tb.n_out
    w = tb.tap_w.to(x.dtype)
    out = None
    for k in range(tb.width):
        term = w[:, k].reshape(bshape) * x.index_select(axis, tb.cols[:, k])
        out = term if out is None else out + term
    return out


def apply_transfer_plain(tbs: Tuple[TransferBand, ...], x: torch.Tensor,
                         add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K7: the per-axis gathers in axis order, then ``add``
    (bf16: each axis in f32 and rounded once, ``add`` inside the last)."""
    if x.dtype == torch.bfloat16:
        f32 = torch.float32
        for a, tb in enumerate(tbs):
            y = apply_transfer_axis(tb, x.to(f32), a)
            if add is not None and a == len(tbs) - 1:
                y = add.to(f32) + y
            x = y.to(torch.bfloat16)
        return x
    for a, tb in enumerate(tbs):
        x = apply_transfer_axis(tb, x, a)
    return x if add is None else add + x


def _span(tb: Optional[TransferBand], T: int) -> int:
    """Input rows a run of T outputs of ``tb`` can read, cyclically from
    the first one's c0: its steps and one band (at most the whole axis and
    a band past it); 1 on a lifted axis."""
    if tb is None:
        return 1
    return min((T - 1) * tb.step + tb.width, tb.n_in + tb.width - 1)


def _smem_bytes(tbs, T1, T2, L1, L2, chunk, itemsize):
    """Shared memory of a block (csrc/transfer.cu::smem_bytes): the staged
    sums and the per-tap tables."""
    W0, W1, W2 = (1 if tb is None else tb.width for tb in tbs)
    return ((chunk * W0 + L1) * 8
            + (L1 * L2 + T1 * L2 + chunk * W0 + T1 * W1 + T2 * W2) * itemsize
            + (L2 + T1 * W1 + T2 * W2) * 4)


def transfer_tiling(tbs, itemsize: int, sms: int = SM_COUNT):
    """(T1, T2, L1, L2, chunk) of the fused kernel for the bands of a field
    lifted to 3D (``None`` on a lifted axis): a block owns a T1 × T2 tile of
    ``chunk`` consecutive output planes and stages L1 × L2 axis-0 sums and
    T1 × L2 axis-1 sums in shared memory.  Tiles split each axis evenly; the
    widest tiles (up to 32 × 32, or 256 outputs on a 1D field) that still
    give every SM two blocks are taken, 8 × 8 at the least; runs of planes
    then bring the blocks down to about four an SM, which spreads the cost
    of a block's tables."""
    m0, m1, m2 = (1 if tb is None else tb.n_out for tb in tbs)
    best = None
    for cap in (32, 16, 8):
        cap2 = cap if m1 > 1 else 8 * cap
        T1 = math.ceil(m1 / math.ceil(m1 / cap))
        T2 = math.ceil(m2 / math.ceil(m2 / cap2))
        L1, L2 = _span(tbs[1], T1), _span(tbs[2], T2)
        if _smem_bytes(tbs, T1, T2, L1, L2, 1, itemsize) > SMEM_LIMIT:
            continue
        best = (T1, T2, L1, L2)
        tiles = math.ceil(m1 / T1) * math.ceil(m2 / T2)
        if m0 * tiles >= 2 * sms:
            break
    if best is None:
        raise ValueError("the transfer's bands read more rows than a block "
                         "of the kernel can stage")
    chunk = max(1, min(m0, m0 * tiles // (4 * sms)))
    chunk = math.ceil(m0 / math.ceil(m0 / chunk))   # even runs
    while _smem_bytes(tbs, *best, chunk, itemsize) > SMEM_LIMIT:
        chunk -= 1
    return (*best, chunk)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("transfer")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.transfer_apply.argtypes = [ptr] * 12 + [ptr, i32, ptr]
    lib.transfer_apply.restype = i32
    lib.transfer_error_string.argtypes = [i32]
    lib.transfer_error_string.restype = ctypes.c_char_p
    return lib


def apply_transfer(tbs: Tuple[TransferBand, ...], x: torch.Tensor,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply per-axis banded transfers (tensor-product operator) to x;
    ``add`` (the result's shape) is added to the result: the prolongation's
    x + P·x_c in the last axis' pass.  CPU tensors take the plain version;
    CUDA tensors launch K7 once (1D, 2D and 3D fields) or raise."""
    if x.device.type == "cpu":
        return apply_transfer_plain(tbs, x, add)
    if x.device.type != "cuda":
        raise NotImplementedError(f"apply_transfer on {x.device.type} tensors")
    if len(tbs) != x.ndim:
        raise ValueError(f"{len(tbs)} transfer bands for a {x.ndim}-D field")
    if not 1 <= x.ndim <= 3:
        raise NotImplementedError(f"the transfer kernel takes 1D to 3D "
                                  f"fields, got {x.ndim}-D")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the transfer kernel takes float32, float64 or "
                        f"bfloat16, got {x.dtype}")
    with torch.cuda.device(x.device):
        return _launch(tbs, x, add, torch.cuda.current_stream().cuda_stream)


def _launch(tbs, x, add, stream):
    """Check the operands and launch the kernel once on ``stream``."""
    lib = _library()
    for a, tb in enumerate(tbs):
        if tb.tap_w.dtype != x.dtype or tb.tap_w.device != x.device \
                or tb.cols.device != x.device:
            raise ValueError("transfer weights and x must share device and "
                             "dtype")
        if tb.c0.dtype != torch.int64:
            raise TypeError(f"c0 must be int64, got {tb.c0.dtype}")
        if x.shape[a] != tb.n_in or tb.c0.shape[0] != tb.n_out:
            raise ValueError(f"axis {a} has {x.shape[a]} points, the "
                             f"transfer maps {tb.n_in} to {tb.n_out}")
    shape = tuple(tb.n_out for tb in tbs)
    if add is not None and (tuple(add.shape) != shape or add.dtype != x.dtype
                            or add.device != x.device):
        raise ValueError(f"add has shape {tuple(add.shape)} {add.dtype}, "
                         f"expected {shape} {x.dtype}")
    lifted = (None,) * (3 - x.ndim) + tuple(tbs)
    itemsize = 4 if x.dtype == torch.bfloat16 else x.element_size()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = [v for tb in lifted for v in (
        (1, 1, 1) if tb is None else (tb.n_in, tb.n_out, tb.width))]
    geo += transfer_tiling(lifted, itemsize, sms)
    # the operands stay referenced here until the launch is queued
    ops = [x.contiguous(), None if add is None else add.contiguous(),
           torch.empty(shape, dtype=x.dtype, device=x.device)]
    ops += [t for tb in lifted for t in (
        (None, None, None) if tb is None
        else (tb.tap_w.contiguous(), tb.cols.contiguous(),
              tb.c0.contiguous()))]
    y = ops[2]
    err = lib.transfer_apply(
        *(None if t is None else t.data_ptr() for t in ops),
        (ctypes.c_int * len(geo))(*geo), _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("apply_transfer kernel launch failed: "
                           + lib.transfer_error_string(err).decode())
    _count.count(apply_transfer, x.dtype)
    return y


_count.attach(apply_transfer)
