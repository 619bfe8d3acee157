"""Restriction / prolongation application — banded per-axis gathers.

Counterpart of ``poms_tpu.ops.transfer``: a tensor-product transfer
P = ⊗_a P_1^(a) is applied one axis at a time, each 1D application being

    y[..., i, ...] = Σ_t  w[i, t] · x[..., c0[i] + t, ...]

K7: for CUDA tensors :func:`apply_transfer` launches the hand-written kernel
of ``csrc/transfer.cu`` once per axis (or raises); for CPU tensors it runs
:func:`apply_transfer_plain`.  The kernel adds the taps in the plain
version's order with multiplies and adds the compiler may not fuse, so its
result equals the plain version's bit for bit.  ``apply_transfer.launches``
counts kernel launches (``launches_by_dtype[name]`` those of one
instantiation).  f32, f64 and bf16: in bf16 weights and fields are bf16,
each axis' taps are multiplied and added in f32 (with the addend, in the
last axis) and rounded once, in the kernel and in the plain version alike.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from poms_tpu_torch.core.space import resolve_device
from poms_tpu_torch.ops import _build, _count

__all__ = ["TransferBand", "bands_from_dense", "apply_transfer_axis",
           "apply_transfer", "apply_transfer_plain"]

# the kernel's dtype codes (csrc/transfer.cu::transfer_axis)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


@dataclass
class TransferBand:
    """Banded 1D transfer: out[i] = Σ_t w[i, t] * x[c0[i] + t].

    ``w`` (n_out, W); ``c0`` (n_out,) int64, clipped so that
    c0[i] + W <= n_in, with zero weights padding the clipped rows.
    """
    w: torch.Tensor
    c0: torch.Tensor
    n_in: int

    @property
    def n_out(self) -> int:
        return self.w.shape[0]

    @property
    def width(self) -> int:
        return self.w.shape[1]


def bands_from_dense(P: np.ndarray, dtype=torch.float64,
                     device=None) -> TransferBand:
    """Extract the banded form of a dense (n_out, n_in) transfer matrix
    (``device=None``: the current CUDA card, an error when there is none)."""
    device = resolve_device(device)
    P = np.asarray(P)
    n_out, n_in = P.shape
    nz = np.abs(P) > 0.0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    W = int((last - first + 1).max())
    W = min(W, n_in)
    c0 = np.minimum(first, n_in - W).astype(np.int64)
    w = np.zeros((n_out, W))
    for t in range(W):
        w[:, t] = P[np.arange(n_out), c0 + t]
    return TransferBand(w=torch.as_tensor(w, dtype=dtype, device=device),
                        c0=torch.as_tensor(c0, device=device), n_in=n_in)


def apply_transfer_axis(tb: TransferBand, x: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """Apply a 1D banded transfer along one axis of a d-D interior array."""
    bshape = [1] * x.ndim
    bshape[axis] = tb.n_out
    out = None
    for t in range(tb.width):
        term = tb.w[:, t].reshape(bshape) * x.index_select(axis, tb.c0 + t)
        out = term if out is None else out + term
    return out


def apply_transfer_plain(tbs: Tuple[TransferBand, ...], x: torch.Tensor,
                         add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K7: the per-axis gathers in axis order, then ``add``
    (bf16: each axis in f32 and rounded once, ``add`` inside the last)."""
    if x.dtype == torch.bfloat16:
        f32 = torch.float32
        for a, tb in enumerate(tbs):
            y = apply_transfer_axis(
                TransferBand(w=tb.w.to(f32), c0=tb.c0, n_in=tb.n_in),
                x.to(f32), a)
            if add is not None and a == len(tbs) - 1:
                y = add.to(f32) + y
            x = y.to(torch.bfloat16)
        return x
    for a, tb in enumerate(tbs):
        x = apply_transfer_axis(tb, x, a)
    return x if add is None else add + x


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("transfer")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.transfer_axis.argtypes = [ptr] * 5 + [i64, i32, i32, i64, i32, i32,
                                              ptr]
    lib.transfer_axis.restype = i32
    lib.transfer_error_string.argtypes = [i32]
    lib.transfer_error_string.restype = ctypes.c_char_p
    return lib


def apply_transfer(tbs: Tuple[TransferBand, ...], x: torch.Tensor,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply per-axis banded transfers (tensor-product operator) to x;
    ``add`` (the result's shape) is added to the result: the prolongation's
    x + P·x_c in the last axis' pass.  CPU tensors take the plain version;
    CUDA tensors launch K7 once per axis or raise."""
    if x.device.type == "cpu":
        return apply_transfer_plain(tbs, x, add)
    if x.device.type != "cuda":
        raise NotImplementedError(f"apply_transfer on {x.device.type} tensors")
    if len(tbs) != x.ndim:
        raise ValueError(f"{len(tbs)} transfer bands for a {x.ndim}-D field")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the transfer kernel takes float32, float64 or "
                        f"bfloat16, got {x.dtype}")
    with torch.cuda.device(x.device):
        return _launch(tbs, x, add, torch.cuda.current_stream().cuda_stream)


def _launch(tbs, x, add, stream):
    """Check the operands and launch one kernel per axis on ``stream``."""
    lib = _library()
    x = x.contiguous()
    for a, tb in enumerate(tbs):
        if tb.w.dtype != x.dtype or tb.w.device != x.device \
                or tb.c0.device != x.device:
            raise ValueError("transfer weights and x must share device and "
                             "dtype")
        if tb.c0.dtype != torch.int64:
            raise TypeError(f"c0 must be int64, got {tb.c0.dtype}")
        if x.shape[a] != tb.n_in or tb.c0.shape[0] != tb.n_out:
            raise ValueError(f"axis {a} has {x.shape[a]} points, the "
                             f"transfer maps {tb.n_in} to {tb.n_out}")
        shape = list(x.shape)
        shape[a] = tb.n_out
        y = torch.empty(shape, dtype=x.dtype, device=x.device)
        addend = None
        if add is not None and a == len(tbs) - 1:
            if (tuple(add.shape) != tuple(shape) or add.dtype != x.dtype
                    or add.device != x.device):
                raise ValueError(f"add has shape {tuple(add.shape)} "
                                 f"{add.dtype}, expected {tuple(shape)} "
                                 f"{x.dtype}")
            addend = add.contiguous()
        outer = 1
        for n in x.shape[:a]:
            outer *= n
        inner = 1
        for n in x.shape[a + 1:]:
            inner *= n
        err = lib.transfer_axis(
            x.data_ptr(), tb.w.contiguous().data_ptr(),
            tb.c0.contiguous().data_ptr(),
            None if addend is None else addend.data_ptr(), y.data_ptr(),
            outer, tb.n_in, tb.n_out, inner, tb.width,
            _DTYPE_CODES[x.dtype], stream)
        if err != 0:
            raise RuntimeError("apply_transfer kernel launch failed: "
                               + lib.transfer_error_string(err).decode())
        _count.count(apply_transfer, x.dtype)
        x = y
    return x


_count.attach(apply_transfer)
