"""Stencil vector spaces — index metadata for tensor-product B-spline grids.

PyTorch counterpart of ``poms_tpu.core.space``: the number of interior basis
functions per dimension, the ghost width per dimension (= spline degree),
periodicity flags, the field dtype and the device the fields live on.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

__all__ = ["StencilVectorSpace"]


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
    ``torch.dtype`` and ``device`` a ``torch.device`` for field data.
    """

    npts: Tuple[int, ...]
    pads: Tuple[int, ...]
    periodic: Tuple[bool, ...] = None  # type: ignore[assignment]
    dtype: torch.dtype = torch.float64
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        d = len(self.npts)
        object.__setattr__(self, "npts", tuple(int(n) for n in self.npts))
        object.__setattr__(self, "pads", _as_tuple(self.pads, d, "pads"))
        per = self.periodic if self.periodic is not None else False
        object.__setattr__(self, "periodic", _as_tuple(per, d, "periodic"))
        object.__setattr__(self, "device", torch.device(self.device))
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
    def interior(self) -> Tuple[slice, ...]:
        """Slices selecting the interior of a padded array."""
        return tuple(slice(p, p + n) for n, p in zip(self.npts, self.pads))

    def with_dtype(self, dtype: torch.dtype) -> "StencilVectorSpace":
        return replace(self, dtype=dtype)
