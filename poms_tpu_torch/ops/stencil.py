"""K2: the banded stencil apply in its four modes, and its plain versions.

Counterpart of ``poms_tpu/ops/spmv.py`` (the shifted-multiply-add sums) and
of the v1 Pallas engine ``poms_tpu/ops/pallas/spmv.py::_stencil_call``.
A tensor-product B-spline stencil matrix is a dense band of (2p+1)^d
coefficients per point, stored offset-major (``band_t[k..., i...]``
multiplies ``x[i + k - p]``), and its SpMV is a sum of (2p+1)^d shifted
multiply-adds over the ghost-padded input:

    out[i] = Σ_k band_t[k, i] · x_pad[i + k]          (k in [0, 2p]^d)

:func:`stencil_apply` runs one of the modes ``spmv``, ``residual``
(b − Ax), ``jacobi`` (x + ω(b − Ax)/diag) or ``rbgs`` (one red-black
Gauss–Seidel colour phase).  For a CUDA tensor it launches the hand-written
kernel of ``csrc/stencil_apply.cu`` (f32 or f64; 1D and 2D lifted to 3D) or
raises; for a CPU tensor it runs :func:`stencil_apply_plain`, the JAX
package's jnp expressions (``poms_tpu/ops/dispatch.py``) in PyTorch.
``stencil_apply.launches[mode]`` counts kernel launches per mode.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional, Sequence, Tuple

import torch

from poms_tpu_torch.core.space import resolve_device
from poms_tpu_torch.ops import _build

__all__ = ["MODES", "diagonal_band_index", "spmv_banded_plain",
           "spmv_offdiag_plain", "color_mask", "stencil_apply_plain",
           "stencil_apply"]

MODES = ("spmv", "residual", "jacobi", "rbgs")
_KERNELS = {torch.float32: ("stencil_apply_f32", ctypes.c_float),
            torch.float64: ("stencil_apply_f64", ctypes.c_double)}


def diagonal_band_index(pads: Tuple[int, ...]) -> Tuple[int, ...]:
    """Band index of the matrix diagonal: offset 0 lives at k = p per dim."""
    return tuple(pads)


def _band_offsets(pads):
    """All band index tuples k in [0, 2p]^d, in the JAX package's order."""
    return itertools.product(*[range(2 * p + 1) for p in pads])


def _shifted(x_pad: torch.Tensor, k, npts) -> torch.Tensor:
    return x_pad[tuple(slice(ki, ki + n) for ki, n in zip(k, npts))]


def spmv_banded_plain(band_t: torch.Tensor, x_pad: torch.Tensor, npts,
                      pads) -> torch.Tensor:
    """out[i] = Σ_k band_t[k, i] · x_pad[i + k], summed in offset order."""
    out = None
    for k in _band_offsets(pads):
        term = band_t[k] * _shifted(x_pad, k, npts)
        out = term if out is None else out + term
    return out


def spmv_offdiag_plain(band_t: torch.Tensor, x_pad: torch.Tensor, npts,
                       pads) -> torch.Tensor:
    """Like :func:`spmv_banded_plain` without the diagonal term:
    (A x)_offdiag for the Jacobi and Gauss–Seidel sweeps."""
    diag_k = diagonal_band_index(tuple(pads))
    out = None
    for k in _band_offsets(pads):
        if k == diag_k:
            continue
        term = band_t[k] * _shifted(x_pad, k, npts)
        out = term if out is None else out + term
    if out is None:   # pads all zero: purely diagonal matrix
        out = torch.zeros(tuple(npts), dtype=band_t.dtype,
                          device=band_t.device)
    return out


def color_mask(npts: Tuple[int, ...], color: int,
               starts: Optional[Tuple[int, ...]] = None,
               device=None) -> torch.Tensor:
    """Boolean mask of grid points with (Σ global index) % 2 == color.

    ``starts`` are the global offsets of this block: the colour of a point
    depends on its global index (distributed red-black).  ``device=None``
    is the current CUDA card (an error when there is none)."""
    device = resolve_device(device)
    total = None
    for a, n in enumerate(npts):
        shape = [1] * len(npts)
        shape[a] = n
        idx = torch.arange(n, device=device).reshape(shape)
        if starts is not None:
            idx = idx + starts[a]
        total = idx if total is None else total + idx
    return (total.expand(tuple(npts)) % 2) == color


def _interior(x_pad: torch.Tensor, npts, pads) -> torch.Tensor:
    return x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]


def stencil_apply_plain(mode: str, band_t: torch.Tensor, x_pad: torch.Tensor,
                        npts, pads, b: Optional[torch.Tensor] = None,
                        omega: Optional[float] = None, color: int = 0,
                        starts=None) -> torch.Tensor:
    """Plain PyTorch K2: the jnp branch of ``poms_tpu/ops/dispatch.py``."""
    npts, pads = tuple(npts), tuple(pads)
    if mode == "spmv":
        return spmv_banded_plain(band_t, x_pad, npts, pads)
    if mode == "residual":
        return b - spmv_banded_plain(band_t, x_pad, npts, pads)
    diag = band_t[diagonal_band_index(pads)]
    x_int = _interior(x_pad, npts, pads)
    if mode == "jacobi":
        Ax = spmv_banded_plain(band_t, x_pad, npts, pads)
        return x_int + omega * (b - Ax) / diag
    if mode == "rbgs":
        s = spmv_offdiag_plain(band_t, x_pad, npts, pads)
        gs = (b - s) / diag
        mask = color_mask(npts, color, starts, device=x_pad.device)
        return torch.where(mask, (1.0 - omega) * x_int + omega * gs, x_int)
    raise ValueError(f"unknown stencil mode {mode!r}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("stencil_apply")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn, scalar in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = ([ptr] * 4 + [scalar] + [i32] * 6 + [i64] * 3
                      + [i32, i32, i64, ptr])
        f.restype = i32
    lib.stencil_apply_error_string.argtypes = [i32]
    lib.stencil_apply_error_string.restype = ctypes.c_char_p
    return lib


def _lift(npts: Sequence[int], pads: Sequence[int]):
    """1D/2D geometry as 3D: (1, 1, n) / (1, n1, n2), zero pads on the
    lifted axes (a lifted axis has index 0, so the parity is unchanged)."""
    lead = 3 - len(npts)
    return (1,) * lead + tuple(npts), (0,) * lead + tuple(pads)


def _check(band_t, x_pad, b, npts, pads):
    if x_pad.dtype not in _KERNELS:
        raise TypeError(f"stencil_apply kernel takes float32/float64, "
                        f"got {x_pad.dtype}")
    if not 1 <= len(npts) <= 3 or len(pads) != len(npts):
        raise NotImplementedError(
            f"stencil_apply covers 1D/2D/3D fields, got npts={npts}")
    want_band = tuple(2 * p + 1 for p in pads) + tuple(npts)
    if tuple(band_t.shape) != want_band:
        raise ValueError(f"band_t has shape {tuple(band_t.shape)}, expected "
                         f"{want_band}")
    want_x = tuple(n + 2 * p for n, p in zip(npts, pads))
    if tuple(x_pad.shape) != want_x:
        raise ValueError(f"x_pad has shape {tuple(x_pad.shape)}, expected "
                         f"{want_x}")
    if not band_t.is_contiguous():
        raise ValueError("band_t must be contiguous (StencilMatrix stores "
                         "it so); a copy per apply would double its traffic")
    for t in (band_t, b):
        if t is not None and (t.device != x_pad.device
                              or t.dtype != x_pad.dtype):
            raise ValueError("band_t, x_pad and b must share device and dtype")
    if b is not None and tuple(b.shape) != tuple(npts):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {npts}")


def stencil_apply(mode: str, band_t: torch.Tensor, x_pad: torch.Tensor,
                  npts, pads, b: Optional[torch.Tensor] = None,
                  omega: Optional[float] = None, color: int = 0,
                  starts=None) -> torch.Tensor:
    """One K2 pass in ``mode`` (see the module docstring).

    ``band_t``: (2p+1 per dim) + npts, offset-major; ``x_pad``: npts + 2p
    per dim with ghosts filled; ``b``: interior-shaped (may be a strided
    view), needed by every mode but ``spmv``; ``omega``: jacobi/rbgs
    damping; ``color``/``starts``: the rbgs colour and the field's global
    index offsets.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    """
    npts, pads = tuple(npts), tuple(pads)
    if mode not in MODES:
        raise ValueError(f"unknown stencil mode {mode!r}")
    if (mode != "spmv") != (b is not None):
        raise ValueError(f"mode {mode!r} {'needs' if b is None else 'takes no'}"
                         " b")
    if mode in ("jacobi", "rbgs") and omega is None:
        raise ValueError(f"mode {mode!r} needs omega")
    if x_pad.device.type == "cpu":
        return stencil_apply_plain(mode, band_t, x_pad, npts, pads, b, omega,
                                   color, starts)
    if x_pad.device.type != "cuda":
        raise NotImplementedError(
            f"stencil_apply on {x_pad.device.type} tensors")
    _check(band_t, x_pad, b, npts, pads)
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
            band_t.data_ptr(), x_pad.data_ptr(),
            None if b3 is None else b3.data_ptr(), out.data_ptr(),
            scalar(0.0 if omega is None else float(omega)), *n3, *p3,
            *strides, MODES.index(mode), int(color), int(pbase), stream)
    if err != 0:
        raise RuntimeError(f"stencil_apply kernel launch failed ({mode}): "
                           + lib.stencil_apply_error_string(err).decode())
    stencil_apply.launches[mode] += 1
    return out


stencil_apply.launches = dict.fromkeys(MODES, 0)
