"""K3: the v2 banded engine, a pipelined variant of K2 over a packed band.

Counterpart of the JAX package's v2 Pallas engine
(``poms_tpu/ops/pallas/spmv.py``: ``pack_band_v2``, ``_stencil_call_v2``,
``_make_kernel_v2``), selected there and here by ``POMS_TPU_SPMV=v2``
(:func:`poms_tpu_torch.ops.dispatch.engine`).  It computes K2's four modes
(``spmv``, ``residual``, ``jacobi``, ``rbgs``; see
:mod:`poms_tpu_torch.ops.stencil`) from a band relaid out once per operator:

- :func:`pack_band_v2` cuts the grid into the kernel's tiles (1D and 2D
  lifted to 3D) and stores, tile after tile, one contiguous slab per
  leading band offset pair (k0, k1): ``[k2][i0][i1][i2]`` over the tile's
  real extent.  Ragged last tiles are packed compactly; only the lane axis
  is rounded up to 16 bytes (``N[2]``), so every slab starts and ends on a
  16-byte boundary, as a bulk copy needs.  The pack is not the JAX
  package's ``blk`` (its tiles are sized for a TPU core), only the same
  idea: every pipeline step of the kernel reads one contiguous slab.
- :func:`stencil_apply_v2` launches ``csrc/stencil_apply_v2.cu`` for CUDA
  tensors (or raises) and runs :func:`stencil_apply_v2_plain` for CPU
  tensors; ``stencil_apply_v2.launches[mode]`` counts kernel launches
  (``launches_by_dtype[name][mode]`` those of one instantiation).  f32, f64
  and bf16: a bf16 pack holds bf16 slabs (8 values per 16 bytes), and the
  kernel and the plain version compute in f32 and round once, as K2's do.
  A pack of another dtype than ``x_pad``'s is refused.
  Called without a pack it packs inline, as the JAX engine does; loops
  pass the operator's pack (``StencilMatrix.ensure_packed_v2``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from poms_tpu_torch.ops import _build, _count
from poms_tpu_torch.ops.stencil import (K2_SMEM, MODES, _lift,
                                        stencil_apply_plain)

__all__ = ["tile_v2", "k3_smem_bytes", "pack_band_v2", "unpack_band_v2",
           "stencil_apply_v2_plain", "stencil_apply_v2"]

_KERNELS = {torch.float32: ("stencil_apply_v2_f32", ctypes.c_float),
            torch.float64: ("stencil_apply_v2_f64", ctypes.c_double),
            torch.bfloat16: ("stencil_apply_v2_bf16", ctypes.c_float)}
# the 3D tiles per dtype, in order: a ring of 3 (k0, k1) slabs plus the x
# window in 227 KB of shared memory.  At p = 3 a slab is 28 KB in f32
# (4×8×32) and in f64 (2×8×32): two blocks an SM; in bf16 (4×8×32) it is 14
# KB and the window (f32) 21 KB: three blocks an SM, 129 KB of slabs in
# flight there.  Wider bands take the first smaller tile that fits (f32
# from p = 7, f64 from p = 6)
_TILES_3D = {torch.float32: ((4, 8, 32), (2, 8, 32), (1, 8, 32), (1, 4, 32)),
             torch.float64: ((2, 8, 32), (1, 8, 32), (1, 4, 32)),
             torch.bfloat16: ((4, 8, 32), (2, 8, 32), (1, 8, 32),
                              (1, 4, 32))}


def tile_v2(npts3, dtype: torch.dtype, pads3):
    """The kernel's (T0, T1, T2) tile for a lifted 3D grid and its pads:
    T1·T2 threads of T0 points each; in 3D the first of ``_TILES_3D`` whose
    block fits the card's shared memory (else the last: the wrapper then
    refuses it)."""
    if npts3[0] == 1 and npts3[1] == 1:
        return (1, 1, 256)
    if npts3[0] == 1:
        return (1, 8, 32)
    if dtype not in _TILES_3D:
        raise TypeError(f"the v2 engine packs float32, float64 or bfloat16 "
                        f"bands, got {dtype}")
    for tile in _TILES_3D[dtype]:
        if k3_smem_bytes(tile, pads3, dtype) <= K2_SMEM:
            break
    return tile


def k3_smem_bytes(tile, pads3, dtype: torch.dtype) -> int:
    """Shared memory of a K3 block (``csrc/stencil_apply_v2.cu::
    launch_tiles``): the ring of 3 slabs and the x window (arithmetic
    type)."""
    T0, T1, T2 = tile
    item = torch.empty((), dtype=dtype).element_size()
    arith = 4 if dtype == torch.bfloat16 else item
    return (3 * (2 * pads3[2] + 1) * T0 * T1 * T2 * item
            + (T0 + 2 * pads3[0]) * (T1 + 2 * pads3[1])
            * (T2 + 2 * pads3[2]) * arith)


def _lane_align(dtype: torch.dtype) -> int:
    """Elements per 16 bytes: the granule of a bulk copy."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _segments(n: int, t: int):
    """(first tile, number of tiles, extent) of the full tiles along an
    axis and of its ragged last tile."""
    segs = [(0, n // t, t)] if n // t else []
    if n % t:
        segs.append((n // t, 1, n % t))
    return segs


def _class_views(blk, band6, n3, tile, n2p):
    """(pack view, band view) pairs, one per class of tiles (full or
    ragged along each axis), both shaped
    (tiles0, tiles1, tiles2, w0, w1, w2, e0, e1, e2).

    Tiles are stored in grid order; the points before tile (a, b, c) are
    i0·n1·n2p + e0·(j0·n2p + e1·l0), with (i0, j0, l0) its first point,
    (e0, e1) its extents and the lane axis rounded to n2p."""
    w0, w1, w2 = band6.shape[:3]
    W = w0 * w1 * w2
    n0, n1, n2 = n3
    T0, T1, T2 = tile
    for a, na, e0 in _segments(n0, T0):
        for b, nb, e1 in _segments(n1, T1):
            for c, nc, e2 in _segments(n2, T2):
                i0, j0, l0 = a * T0, b * T1, c * T2
                r2 = min(T2, n2p - l0)          # lane pitch of the slab
                E = e0 * e1 * r2
                view = blk.as_strided(
                    (na, nb, nc, w0, w1, w2, e0, e1, e2),
                    (W * T0 * n1 * n2p, W * e0 * T1 * n2p, W * E,
                     w1 * w2 * E, w2 * E, E, e1 * r2, r2, 1),
                    W * (i0 * n1 * n2p + e0 * (j0 * n2p + e1 * l0)))
                src = band6[:, :, :, i0:i0 + na * e0, j0:j0 + nb * e1,
                            l0:l0 + nc * e2]
                src = (src.unflatten(3, (na, e0)).unflatten(5, (nb, e1))
                       .unflatten(7, (nc, e2))
                       .permute(3, 5, 7, 0, 1, 2, 4, 6, 8))
                yield view, src


def _band6(band_t: torch.Tensor, nd: int) -> torch.Tensor:
    """(w..., n...) lifted to (w0, w1, w2, n0, n1, n2) with unit axes."""
    lead = (1,) * (3 - nd)
    shape = tuple(band_t.shape)
    return band_t.reshape(lead + shape[:nd] + lead + shape[nd:])


def pack_band_v2(band_t: torch.Tensor, npts, pads) -> dict:
    """Relayout ``band_t`` for K3, once per operator.

    Returns ``blk`` (flat, the band's dtype and device), ``diag`` (the
    centre plane, interior-shaped), ``tile`` (the lifted 3D tile), ``N``
    (the lifted grid the pack covers: the lane axis rounded up to 16
    bytes), ``npts`` and ``pads``."""
    npts, pads = tuple(npts), tuple(pads)
    nd = len(npts)
    want = tuple(2 * p + 1 for p in pads) + npts
    if tuple(band_t.shape) != want:
        raise ValueError(f"band_t has shape {tuple(band_t.shape)}, expected "
                         f"{want}")
    n3, p3 = _lift(npts, pads)
    tile = tile_v2(n3, band_t.dtype, p3)
    align = _lane_align(band_t.dtype)
    n2p = -(-n3[2] // align) * align
    terms = math.prod(want[:nd])
    blk = torch.zeros(terms * n3[0] * n3[1] * n2p, dtype=band_t.dtype,
                      device=band_t.device)
    for view, src in _class_views(blk, _band6(band_t, nd), n3, tile, n2p):
        view.copy_(src)
    return {"blk": blk, "diag": band_t[pads].contiguous(), "tile": tile,
            "N": (n3[0], n3[1], n2p), "npts": npts, "pads": pads}


def unpack_band_v2(packed: dict) -> torch.Tensor:
    """The offset-major ``band_t`` back from a pack (bitwise)."""
    npts, pads = packed["npts"], packed["pads"]
    nd = len(npts)
    blk = packed["blk"]
    band_t = torch.empty(tuple(2 * p + 1 for p in pads) + npts,
                         dtype=blk.dtype, device=blk.device)
    n3, _ = _lift(npts, pads)
    for view, dst in _class_views(blk, _band6(band_t, nd), n3,
                                  packed["tile"], packed["N"][2]):
        dst.copy_(view)
    return band_t


def stencil_apply_v2_plain(mode: str, packed: dict, x_pad: torch.Tensor,
                           npts, pads, b: Optional[torch.Tensor] = None,
                           omega: Optional[float] = None, color: int = 0,
                           starts=None) -> torch.Tensor:
    """Plain PyTorch K3: the band unpacked, then K2's plain modes (bf16:
    in f32, rounded once)."""
    return stencil_apply_plain(mode, unpack_band_v2(packed), x_pad, npts,
                               pads, b, omega, color, starts)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("stencil_apply_v2")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn, scalar in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = ([ptr] * 5 + [scalar] + [i32] * 9 + [i64] * 3
                      + [i32, i32, i64, ptr])
        f.restype = i32
    lib.stencil_apply_v2_error_string.argtypes = [i32]
    lib.stencil_apply_v2_error_string.restype = ctypes.c_char_p
    return lib


def _check(packed, x_pad, b, npts, pads):
    blk, diag = packed["blk"], packed["diag"]
    if x_pad.dtype not in _KERNELS:
        raise TypeError(f"stencil_apply_v2 kernel takes float32, float64 or "
                        f"bfloat16, got {x_pad.dtype}")
    for t in (blk, diag, b):
        if t is not None and (t.device != x_pad.device
                              or t.dtype != x_pad.dtype):
            raise ValueError("the pack, x_pad and b must share device and "
                             "dtype")
    n3, p3 = _lift(npts, pads)
    if packed["tile"] != tile_v2(n3, blk.dtype, p3):
        raise ValueError(f"pack tile {packed['tile']} is not the kernel's "
                         f"{tile_v2(n3, blk.dtype, p3)}")
    terms = math.prod(2 * p + 1 for p in pads)
    if (not blk.is_contiguous() or blk.numel() != terms * math.prod(
            packed["N"]) or blk.data_ptr() % 16):
        raise ValueError("blk is not a pack of this grid")
    if tuple(diag.shape) != tuple(npts) or not diag.is_contiguous():
        raise ValueError(f"diag must be a contiguous {npts} array")
    want_x = tuple(n + 2 * p for n, p in zip(npts, pads))
    if tuple(x_pad.shape) != want_x:
        raise ValueError(f"x_pad has shape {tuple(x_pad.shape)}, expected "
                         f"{want_x}")
    if b is not None and tuple(b.shape) != tuple(npts):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {npts}")
    smem = k3_smem_bytes(packed["tile"], p3, blk.dtype)
    if smem > K2_SMEM:
        raise RuntimeError(
            f"K3 cannot stage a {packed['tile']} tile at pads {pads} in "
            f"{blk.dtype}: its slab ring and x window take {smem} bytes of "
            f"shared memory, and a block may have {K2_SMEM}")


def stencil_apply_v2(mode: str, band_t: Optional[torch.Tensor],
                     x_pad: torch.Tensor, npts, pads,
                     b: Optional[torch.Tensor] = None,
                     omega: Optional[float] = None, color: int = 0,
                     starts=None, packed: Optional[dict] = None
                     ) -> torch.Tensor:
    """One K3 pass in ``mode``; the arguments are K2's
    (:func:`poms_tpu_torch.ops.stencil.stencil_apply`) plus ``packed``, a
    :func:`pack_band_v2` of ``band_t`` for these ``npts``/``pads``.
    Without it ``band_t`` is packed inline (a full band relayout per
    call).  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    npts, pads = tuple(npts), tuple(pads)
    if mode not in MODES:
        raise ValueError(f"unknown stencil mode {mode!r}")
    if (mode != "spmv") != (b is not None):
        raise ValueError(f"mode {mode!r} {'needs' if b is None else 'takes no'}"
                         " b")
    if mode in ("jacobi", "rbgs") and omega is None:
        raise ValueError(f"mode {mode!r} needs omega")
    if packed is None:
        if band_t is None:
            raise ValueError("stencil_apply_v2 needs band_t or packed")
        packed = pack_band_v2(band_t, npts, pads)
    elif packed["npts"] != npts or packed["pads"] != pads:
        raise ValueError(
            f"packed band was built for npts={packed['npts']} "
            f"pads={packed['pads']}, called with npts={npts} pads={pads}")
    if packed["blk"].dtype != x_pad.dtype:
        raise ValueError(f"the pack holds {packed['blk'].dtype} slabs, x_pad "
                         f"is {x_pad.dtype}: pack the band in the field's "
                         "dtype")
    if x_pad.device.type == "cpu":
        return stencil_apply_v2_plain(mode, packed, x_pad, npts, pads, b,
                                      omega, color, starts)
    if x_pad.device.type != "cuda":
        raise NotImplementedError(
            f"stencil_apply_v2 on {x_pad.device.type} tensors")
    _check(packed, x_pad, b, npts, pads)
    x_pad = x_pad.contiguous()
    n3, p3 = _lift(npts, pads)
    b3 = None
    if b is not None:
        b3 = b
        while b3.ndim < 3:
            b3 = b3.unsqueeze(0)
    strides = b3.stride() if b3 is not None else (0, 0, 0)
    out = torch.empty(npts, dtype=x_pad.dtype, device=x_pad.device)
    pbase = sum(starts) if starts is not None else 0
    fn, scalar = _KERNELS[x_pad.dtype]
    lib = _library()
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            packed["blk"].data_ptr(), packed["diag"].data_ptr(),
            x_pad.data_ptr(), None if b3 is None else b3.data_ptr(),
            out.data_ptr(), scalar(0.0 if omega is None else float(omega)),
            *n3, *p3, *packed["tile"], *strides, MODES.index(mode),
            int(color), int(pbase), stream)
    if err != 0:
        raise RuntimeError(f"stencil_apply_v2 kernel launch failed ({mode}): "
                           + lib.stencil_apply_v2_error_string(err).decode())
    _count.count(stencil_apply_v2, x_pad.dtype, mode)
    return out


_count.attach(stencil_apply_v2, MODES)
