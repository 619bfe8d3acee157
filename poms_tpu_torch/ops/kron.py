"""K1: the fused Kronecker-sum apply y = Σ_r (B_r⁽⁰⁾ ⊗ B_r⁽¹⁾ ⊗ B_r⁽²⁾)·x.

Counterpart of ``poms_tpu/ops/pallas/kron.py::kron_apply_pallas``.  For a
CUDA tensor :func:`kron_apply` launches the hand-written kernel in
``csrc/kron_apply.cu`` (3D, f32 or f64) or raises; for a CPU tensor it runs
:func:`kron_apply_plain`, the shared-partial chain of 1D axis contractions of
``poms_tpu/core/kron.py::_apply_interior``.  ``kron_apply.launches`` counts
kernel launches, so a run can show that its applies went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.ops import _build

__all__ = ["kron_apply", "kron_apply_plain", "apply_band_1d_axis",
           "band_labels"]

_KERNELS = {torch.float32: "kron_apply_f32", torch.float64: "kron_apply_f64"}


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


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("kron_apply")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        f.restype = i32
    lib.kron_apply_error_string.argtypes = [i32]
    lib.kron_apply_error_string.restype = ctypes.c_char_p
    return lib


def _check(terms, x_int: torch.Tensor, npts, pads):
    if x_int.dtype not in _KERNELS:
        raise TypeError(f"kron_apply kernel takes float32/float64, "
                        f"got {x_int.dtype}")
    if tuple(x_int.shape) != tuple(npts):
        raise ValueError(f"x has shape {tuple(x_int.shape)}, expected "
                         f"{tuple(npts)}")
    for term in terms:
        if len(term) != 3:
            raise ValueError("each term needs one 1D band per dim")
        for a, B in enumerate(term):
            if tuple(B.shape) != (npts[a], 2 * pads[a] + 1):
                raise ValueError(f"band {a} has shape {tuple(B.shape)}, "
                                 f"expected {(npts[a], 2 * pads[a] + 1)}")
            if B.device != x_int.device or B.dtype != x_int.dtype:
                raise ValueError("bands and x must share device and dtype")


def kron_apply(terms: Sequence[Sequence[torch.Tensor]], x_int: torch.Tensor,
               npts, pads, periodic) -> torch.Tensor:
    """y = (Σ_r ⊗_a B_r^(a)) x for interior field ``x_int``.

    ``terms``: per term, one (n_a, 2p_a+1) band per axis.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
    """
    npts, pads, periodic = tuple(npts), tuple(pads), tuple(periodic)
    if x_int.device.type == "cpu":
        return kron_apply_plain(terms, x_int, npts, pads, periodic)
    if x_int.device.type != "cuda":
        raise NotImplementedError(f"kron_apply on {x_int.device.type} tensors")
    if x_int.ndim != 3:
        raise NotImplementedError(
            f"the kron_apply kernel is 3D; got a {x_int.ndim}D field")
    _check(terms, x_int, npts, pads)
    x_pad = ghost_pad(x_int, pads, periodic).contiguous()
    bands = [torch.stack([term[a] for term in terms]).contiguous()
             for a in range(3)]
    y = torch.empty(npts, dtype=x_int.dtype, device=x_int.device)
    lib = _library()
    with torch.cuda.device(x_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _KERNELS[x_int.dtype])(
            x_pad.data_ptr(), bands[0].data_ptr(), bands[1].data_ptr(),
            bands[2].data_ptr(), y.data_ptr(), len(terms), *npts, *pads,
            stream)
    if err != 0:
        raise RuntimeError("kron_apply kernel launch failed: "
                           + lib.kron_apply_error_string(err).decode())
    kron_apply.launches += 1
    return y


kron_apply.launches = 0
