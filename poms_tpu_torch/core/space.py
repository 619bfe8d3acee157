"""Stencil vector spaces — index metadata for tensor-product B-spline grids.

PyTorch counterpart of ``poms_tpu.core.space``: the number of interior basis
functions per dimension, the ghost width per dimension (= spline degree),
periodicity flags, the field dtype and the device the fields live on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

__all__ = ["StencilVectorSpace", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA card.  Without a card and without an explicit device this
    raises: the port never falls back to the CPU on its own."""
    if device is not None:
        device = torch.device(device)
        if (device.type == "cuda" and device.index is None
                and torch.cuda.is_available()):
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: poms_tpu_torch runs on the card by default; "
            "pass device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _as_tuple(x, d, name):
    if isinstance(x, (int, bool)):
        return (x,) * d
    t = tuple(x)
    if len(t) != d:
        raise ValueError(f"{name} must have length {d}, got {t}")
    return t


@dataclass(frozen=True)
class StencilVectorSpace:
    """Metadata for a d-dimensional tensor-product stencil space.

    ``npts`` interior points per dimension, ``pads`` ghost width per side,
    ``periodic`` flags (non-periodic ghosts are zero), ``dtype`` a
    ``torch.dtype`` and ``device`` a ``torch.device`` for field data
    (``None``: the current CUDA card, or an error when there is none).
    """

    npts: Tuple[int, ...]
    pads: Tuple[int, ...]
    periodic: Tuple[bool, ...] = None  # type: ignore[assignment]
    dtype: torch.dtype = torch.float64
    device: Optional[torch.device] = None

    def __post_init__(self):
        d = len(self.npts)
        object.__setattr__(self, "npts", tuple(int(n) for n in self.npts))
        object.__setattr__(self, "pads", _as_tuple(self.pads, d, "pads"))
        per = self.periodic if self.periodic is not None else False
        object.__setattr__(self, "periodic", _as_tuple(per, d, "periodic"))
        object.__setattr__(self, "device", resolve_device(self.device))
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        for n, p in zip(self.npts, self.pads):
            if n < 1 or p < 0:
                raise ValueError(f"invalid space: npts={self.npts} pads={self.pads}")

    @property
    def ndim(self) -> int:
        return len(self.npts)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Interior shape (no ghosts)."""
        return self.npts

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return tuple(n + 2 * p for n, p in zip(self.npts, self.pads))

    @property
    def band_shape(self) -> Tuple[int, ...]:
        """Shape of the per-row stencil band: (2p+1) per dimension."""
        return tuple(2 * p + 1 for p in self.pads)

    @property
    def size(self) -> int:
        return math.prod(self.npts)

    @property
    def interior(self) -> Tuple[slice, ...]:
        """Slices selecting the interior of a padded array."""
        return tuple(slice(p, p + n) for n, p in zip(self.npts, self.pads))

    def with_dtype(self, dtype: torch.dtype) -> "StencilVectorSpace":
        return replace(self, dtype=dtype)
