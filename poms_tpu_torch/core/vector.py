"""Halo-padded stencil vectors.

PyTorch counterpart of ``poms_tpu.core.vector``.  Operations return new
vectors, as in the JAX package; ghosts are zero (Dirichlet) or a periodic
wrap of the opposite interior slab.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from poms_tpu_torch.core.space import StencilVectorSpace

__all__ = ["StencilVector", "update_ghosts_serial", "ghost_pad"]


def _axis_slices(ndim: int, axis: int, sl: slice) -> Tuple[slice, ...]:
    return tuple(sl if a == axis else slice(None) for a in range(ndim))


def ghost_pad(x: torch.Tensor, pads: Sequence[int],
              periodic: Sequence[bool]) -> torch.Tensor:
    """Pad every axis of ``x`` by ``pads[a]`` per side: zeros, or a wrap.

    ``F.pad(mode="circular")`` needs leading batch dims for 3D input, so
    the wrap is written with slices and ``torch.cat``.
    """
    nd = x.ndim
    if not any(periodic):   # zeros on every axis: one constant-pad pass
        return F.pad(x, [q for p in reversed(pads) for q in (p, p)])
    for a, (p, per) in enumerate(zip(pads, periodic)):
        if p == 0:
            continue
        if per:
            lo = x[_axis_slices(nd, a, slice(x.shape[a] - p, None))]
            hi = x[_axis_slices(nd, a, slice(0, p))]
        else:
            gshape = list(x.shape)
            gshape[a] = p
            lo = hi = x.new_zeros(gshape)
        x = torch.cat([lo, x, hi], dim=a)
    return x


def update_ghosts_serial(data: torch.Tensor,
                         space: StencilVectorSpace) -> torch.Tensor:
    """Fill the ghost regions of a padded array (single-device semantics)."""
    data = data.clone()
    nd = space.ndim
    for a, (n, p, per) in enumerate(zip(space.npts, space.pads, space.periodic)):
        if p == 0:
            continue
        lo_ghost = _axis_slices(nd, a, slice(0, p))
        hi_ghost = _axis_slices(nd, a, slice(p + n, p + n + p))
        if per:
            data[lo_ghost] = data[_axis_slices(nd, a, slice(n, n + p))]
            data[hi_ghost] = data[_axis_slices(nd, a, slice(p, p + p))]
        else:
            data[lo_ghost] = 0
            data[hi_ghost] = 0
    return data


class StencilVector:
    """A field over a :class:`StencilVectorSpace`.

    ``data`` has shape ``space.padded_shape`` (ghosts included); reductions
    use the interior.  A vector made by :meth:`from_interior` keeps the
    interior alone and pads it (zero ghosts) when ``data`` is first read:
    the Kronecker-sum kernels read and write unpadded fields, so on that
    path no padded copy is ever made.
    """

    __slots__ = ("space", "_data", "_interior")

    def __init__(self, space: StencilVectorSpace,
                 data: torch.Tensor | None = None):
        self.space = space
        if data is None:
            data = torch.zeros(space.padded_shape, dtype=space.dtype,
                               device=space.device)
        self._data = data
        self._interior = None

    @classmethod
    def from_interior(cls, space: StencilVectorSpace,
                      interior: torch.Tensor) -> "StencilVector":
        interior = torch.as_tensor(interior, dtype=space.dtype,
                                   device=space.device)
        if tuple(interior.shape) != space.shape:
            raise ValueError(
                f"interior shape {tuple(interior.shape)} != {space.shape}")
        v = cls.__new__(cls)
        v.space = space
        v._data = None
        v._interior = interior
        return v

    @classmethod
    def zeros(cls, space: StencilVectorSpace) -> "StencilVector":
        return cls(space)

    @property
    def data(self) -> torch.Tensor:
        """The padded field; padded here, once, if the vector was made from
        an interior (after that the interior is a view of it)."""
        if self._data is None:
            self._data = ghost_pad(self._interior, self.space.pads,
                                   (False,) * self.space.ndim)
            self._interior = None
        return self._data

    @property
    def interior(self) -> torch.Tensor:
        if self._data is None:
            return self._interior
        return self._data[self.space.interior]

    def toarray(self):
        """Flattened interior as a host numpy array (scipy interop)."""
        return self.interior.detach().cpu().numpy().ravel()

    def update_ghost_regions(self) -> "StencilVector":
        """A copy with ghosts refreshed (zeros, or the periodic wrap)."""
        return StencilVector(self.space,
                             update_ghosts_serial(self.data, self.space))

    def __add__(self, other: "StencilVector") -> "StencilVector":
        return StencilVector(self.space, self.data + other.data)

    def __sub__(self, other: "StencilVector") -> "StencilVector":
        return StencilVector(self.space, self.data - other.data)

    def __mul__(self, scalar) -> "StencilVector":
        return StencilVector(self.space, self.data * scalar)

    __rmul__ = __mul__

    def __neg__(self) -> "StencilVector":
        return StencilVector(self.space, -self.data)

    def axpy(self, alpha, other: "StencilVector") -> "StencilVector":
        return StencilVector(self.space, self.data + alpha * other.data)

    def dot(self, other: "StencilVector") -> torch.Tensor:
        """Interior inner product (a 0-dim tensor on the vector's device)."""
        return torch.vdot(self.interior.reshape(-1),
                          other.interior.reshape(-1))

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def __repr__(self):
        return f"StencilVector(space={self.space.npts}, pads={self.space.pads})"
