"""The rank grid, halo exchange and the distributed stencil primitives.

Counterpart of ``poms_tpu/parallel/halo.py``.  The JAX package partitions
the grid over a ``jax.sharding.Mesh`` inside ``shard_map`` and moves ghost
slabs with ``lax.ppermute``; here every rank is a process of a
``torch.distributed`` group and holds one block:

- :class:`RankGrid`: the Cartesian ``mesh_shape`` over the group's ranks in
  row-major order, the rank's coordinates and its −/+ neighbour on every
  axis (a non-periodic end has none).
- :func:`halo_exchange`: per sharded dim, in dim order (so corners
  arrive), one ``batch_isend_irecv`` of the two ``pad``-wide interior slabs;
  a non-periodic end keeps zero ghosts (the eliminated boundary), a
  periodic axis of extent 1 wraps by a local copy (``ppermute``'s
  self-permutation).  Under gloo the slabs of a CUDA field are staged
  through host memory (gloo's send and receive take host tensors), counted
  in ``RankGrid.staged_bytes``.
- :func:`dist_spmv`: the exchange, then one banded pass (K2, or K3 under
  ``POMS_TPU_SPMV=v2``, through :mod:`poms_tpu_torch.ops.dispatch`) on the
  rank's padded block; ``overlap=True`` posts the exchange, runs the
  interior with zero ghosts and adds the ghosts' share on the disjoint face
  partition (linearity), as the JAX package's overlap form does.
- :func:`dist_dot`, :func:`dist_norm2`: a local reduction and one f64
  ``all_reduce`` (the JAX package's ``psum``).

Every function works on the rank's block; collectives run on the grid's
group (the default group unless one is given).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from poms_tpu_torch.ops import dispatch

__all__ = ["RankGrid", "AxisSpec", "HaloSpec", "halo_exchange",
           "pad_and_exchange", "dist_spmv", "dist_spmv_offdiag",
           "face_bands", "dist_dot", "dist_norm2", "all_reduce_sum",
           "local_starts", "gather_blocks"]


@dataclass(eq=False)
class RankGrid:
    """The ranks of ``group`` as a row-major Cartesian ``mesh_shape``.

    ``staged_bytes`` counts the halo bytes copied between a card and host
    memory (both ways) under gloo.  ``census``, when a list, receives one
    record per message direction posted (``kind="p2p"``: the dim, ``fwd``
    or ``bwd``, the slab's shape, dtype and bytes, and whether this rank
    has a peer that way) and per collective (``all_reduce``,
    ``all_gather``): what ``bench/scaling_model.py`` counts."""
    mesh_shape: Tuple[int, ...]
    rank: int
    backend: str
    group: Optional[object] = None
    staged_bytes: int = 0
    census: Optional[list] = None

    def record(self, kind: str, shape, dtype: torch.dtype,
               **extra) -> None:
        """Add one record to ``census`` (when counting)."""
        if self.census is not None:
            self.census.append({
                "kind": kind, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "bytes": math.prod(shape) * dtype.itemsize, **extra})

    @classmethod
    def current(cls, mesh_shape, group=None) -> "RankGrid":
        """The grid of this process in ``group`` (default: the world), whose
        size must be the mesh's."""
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "parallel.bootstrap.initialize first")
        mesh_shape = tuple(int(m) for m in mesh_shape)
        size = dist.get_world_size(group)
        if math.prod(mesh_shape) != size:
            raise ValueError(f"mesh {mesh_shape} needs "
                             f"{math.prod(mesh_shape)} ranks, the process "
                             f"group has {size}")
        return cls(mesh_shape, dist.get_rank(group),
                   dist.get_backend(group), group)

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank,
                                                      self.mesh_shape))

    def neighbor(self, a: int, step: int, periodic: bool) -> Optional[int]:
        """The rank ``step`` (±1) along axis ``a``; None past a
        non-periodic end."""
        c = list(self.coords)
        c[a] += step
        if not 0 <= c[a] < self.mesh_shape[a]:
            if not periodic:
                return None
            c[a] %= self.mesh_shape[a]
        return int(np.ravel_multi_index(c, self.mesh_shape))

    def global_rank(self, r: int) -> int:
        """The default-group rank of group rank ``r`` (what P2P ops take)."""
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def stages(self, t: torch.Tensor) -> bool:
        """Whether messages of ``t`` go through host memory."""
        return self.backend == "gloo" and t.device.type == "cuda"


@dataclass(frozen=True)
class AxisSpec:
    name: Optional[str]   # mesh axis name (None = a dim held whole)
    size: int             # ranks along this axis
    n_loc: int            # local interior extent
    pad: int
    periodic: bool


@dataclass(frozen=True)
class HaloSpec:
    """Static per-dimension communication description, and the grid."""
    axes: Tuple[AxisSpec, ...]
    grid: RankGrid = field(compare=False)

    @classmethod
    def build(cls, names, mesh_shape, n_loc, pads, periodic,
              grid: Optional[RankGrid] = None) -> "HaloSpec":
        grid = grid if grid is not None else RankGrid.current(mesh_shape)
        axes = tuple(
            AxisSpec(name=names[a], size=mesh_shape[a], n_loc=n_loc[a],
                     pad=pads[a], periodic=periodic[a])
            for a in range(len(n_loc)))
        return cls(axes=axes, grid=grid)

    @property
    def n_loc(self):
        return tuple(ax.n_loc for ax in self.axes)

    @property
    def pads(self):
        return tuple(ax.pad for ax in self.axes)

    @property
    def names(self):
        return tuple(ax.name for ax in self.axes if ax.name is not None)


def _axis(x, a, start, stop):
    return tuple(slice(start, stop) if b == a else slice(None)
                 for b in range(x.ndim))


class _Exchange:
    """The exchange of one dim posted (:func:`_post`), finished by
    :meth:`wait`, which writes the received slabs into the ghosts."""

    def __init__(self, x_pad, a, p, n, works, recvs, grid):
        self.x_pad, self.a, self.p, self.n = x_pad, a, p, n
        self.works, self.recvs, self.grid = works, recvs, grid

    def wait(self):
        for w in self.works:
            w.wait()
        x, a, p, n = self.x_pad, self.a, self.p, self.n
        for (lo_side, buf) in self.recvs:
            sl = _axis(x, a, 0, p) if lo_side else _axis(x, a, p + n,
                                                          p + n + p)
            if self.grid.stages(x):
                self.grid.staged_bytes += buf.numel() * buf.element_size()
            x[sl] = buf.to(x.device)


def _post(x_pad: torch.Tensor, a: int, ax: AxisSpec,
          grid: RankGrid) -> Optional[_Exchange]:
    """Post dim ``a``'s exchange: the last ``p`` interior rows to the +
    neighbour, the first ``p`` to the − neighbour, and the two receives
    (tags tell the directions apart when both neighbours are one rank).
    None when the dim needs no message (local wrap or zero ghosts)."""
    p, n = ax.pad, ax.n_loc
    if p == 0:
        return None
    if ax.name is None or ax.size == 1:
        if ax.periodic:   # the serial wrap, as ppermute onto itself
            x_pad[_axis(x_pad, a, 0, p)] = x_pad[_axis(x_pad, a, n, n + p)]
            x_pad[_axis(x_pad, a, p + n, p + n + p)] = \
                x_pad[_axis(x_pad, a, p, 2 * p)]
        return None
    hi = grid.neighbor(a, +1, ax.periodic)
    lo = grid.neighbor(a, -1, ax.periodic)
    stage = grid.stages(x_pad)
    where = torch.device("cpu") if stage else x_pad.device
    ops, recvs = [], []
    fwd, bwd = 2 * a, 2 * a + 1
    for peer, sl, tag in ((hi, _axis(x_pad, a, n, n + p), fwd),
                          (lo, _axis(x_pad, a, p, 2 * p), bwd)):
        if peer is None:
            continue
        buf = x_pad[sl].to(where).contiguous()
        if stage:
            grid.staged_bytes += buf.numel() * buf.element_size()
        ops.append(dist.P2POp(dist.isend, buf, grid.global_rank(peer),
                              grid.group, tag))
    shape = list(x_pad.shape)
    shape[a] = p
    for direction, peer in (("fwd", hi), ("bwd", lo)):
        grid.record("p2p", shape, x_pad.dtype, dim=a, direction=direction,
                    sent=peer is not None)
    for peer, lo_side, tag in ((lo, True, fwd), (hi, False, bwd)):
        if peer is None:
            continue
        buf = torch.empty(shape, dtype=x_pad.dtype, device=where)
        ops.append(dist.P2POp(dist.irecv, buf, grid.global_rank(peer),
                              grid.group, tag))
        recvs.append((lo_side, buf))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Exchange(x_pad, a, p, n, works, recvs, grid)


class PendingHalo:
    """An exchange in flight: dim 0's messages are posted, :meth:`wait`
    finishes them and runs the later dims (each needs the ghosts of the
    dims before it, so that corners arrive)."""

    def __init__(self, x_pad: torch.Tensor, spec: HaloSpec):
        self.x_pad, self.spec = x_pad, spec
        self._next = 0
        self._pending = self._advance()

    def _advance(self):
        while self._next < len(self.spec.axes):
            a = self._next
            self._next += 1
            ex = _post(self.x_pad, a, self.spec.axes[a], self.spec.grid)
            if ex is not None:
                return ex
        return None

    def wait(self) -> torch.Tensor:
        while self._pending is not None:
            self._pending.wait()
            self._pending = self._advance()
        return self.x_pad


def halo_exchange(x_pad: torch.Tensor, spec: HaloSpec,
                  async_op: bool = False):
    """Fill the ghost slabs of the rank's padded block from its neighbours,
    in place, and return it (or, with ``async_op``, a :class:`PendingHalo`
    whose ``wait()`` returns it).  ``x_pad`` enters with zero ghosts."""
    pending = PendingHalo(x_pad, spec)
    return pending if async_op else pending.wait()


def _pad(x_loc: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    return F.pad(x_loc, [q for p in reversed(tuple(pads)) for q in (p, p)])


def pad_and_exchange(x_loc: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    return halo_exchange(_pad(x_loc, spec.pads), spec)


def face_bands(band_loc: torch.Tensor, spec: HaloSpec):
    """(rows, contiguous band of those rows) per face: the operands of the
    overlap form's corrections, made once per operator.  The rows the
    ghosts reach are cut into disjoint faces: face (a, side) owns the rows
    in dim a's edge slab whose dims b < a are interior (side 0 absorbs the
    overlap where n_loc < 2p), as the JAX package's overlap form cuts
    them."""
    n_loc, pads = spec.n_loc, spec.pads
    nd = len(n_loc)
    faces = []
    for a in range(nd):
        p_a = pads[a]
        if p_a == 0:
            continue
        for side in (0, 1):
            row_sel = []
            for b in range(nd):
                if b < a:
                    row_sel.append(slice(pads[b],
                                         max(pads[b], n_loc[b] - pads[b])))
                elif b == a:
                    row_sel.append(
                        slice(0, min(p_a, n_loc[a])) if side == 0
                        else slice(max(p_a, n_loc[a] - p_a), n_loc[a]))
                else:
                    row_sel.append(slice(0, n_loc[b]))
            rows = tuple(row_sel)
            if all(s.stop > s.start for s in rows):
                faces.append((rows, band_loc[(slice(None),) * nd
                                             + rows].contiguous()))
    return faces


def dist_spmv(band_loc: torch.Tensor, x_loc: torch.Tensor, spec: HaloSpec,
              overlap: bool = False, packed=None, faces=None):
    """Distributed banded SpMV on the rank's block.

    ``packed``: ``pack_band_v2`` of ``band_loc`` (the v2 engine).
    ``overlap=True``: A·x = A·(x with zero ghosts) + A·(ghosts only); the
    first term needs no message and is computed while dim 0's exchange is
    in flight, the second touches the faces only.  ``faces``: the
    :func:`face_bands` of ``band_loc`` (each with its pack under v2, as
    ``(rows, band, packed)``), made here when None."""
    n_loc, pads = spec.n_loc, spec.pads
    if not overlap:
        x_pad = pad_and_exchange(x_loc, spec)
        return dispatch.spmv(band_loc, x_pad, n_loc, pads, packed=packed)
    x_pad0 = _pad(x_loc, pads)
    pending = halo_exchange(x_pad0.clone(), spec, async_op=True)
    out = dispatch.spmv(band_loc, x_pad0, n_loc, pads, packed=packed)
    x_ghost = pending.wait()
    x_ghost[tuple(slice(p, p + n) for p, n in zip(pads, n_loc))] = 0
    if faces is None:
        faces = [(rows, band, None) for rows, band in face_bands(band_loc,
                                                                 spec)]
    for rows, band, pk in faces:
        shape = tuple(s.stop - s.start for s in rows)
        xw = x_ghost[tuple(slice(s.start, s.stop + 2 * p)
                           for s, p in zip(rows, pads))]
        out[rows] += dispatch.spmv(band, xw, shape, pads, packed=pk)
    return out


def dist_spmv_offdiag(band_loc: torch.Tensor, x_loc: torch.Tensor,
                      spec: HaloSpec) -> torch.Tensor:
    """(A x)_offdiag on the rank's block (plain, as the JAX package's)."""
    from poms_tpu_torch.ops.stencil import spmv_offdiag_plain

    x_pad = pad_and_exchange(x_loc, spec)
    return spmv_offdiag_plain(band_loc, x_pad, spec.n_loc, spec.pads)


def all_reduce_sum(t: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """Sum of a (small) tensor over the grid's ranks, on t's device; under
    gloo a CUDA tensor goes through host memory."""
    grid.record("all_reduce", t.shape, t.dtype)
    if grid.stages(t):
        host = t.cpu()
        dist.all_reduce(host, group=grid.group)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=grid.group)
    return out


def dist_dot(a_loc: torch.Tensor, b_loc: torch.Tensor, spec: HaloSpec):
    """Global inner product: local ``vdot`` and one ``all_reduce``."""
    local = torch.vdot(a_loc.reshape(-1), b_loc.reshape(-1))
    return all_reduce_sum(local, spec.grid) if spec.names else local


def dist_norm2(a_loc: torch.Tensor, spec: HaloSpec):
    return torch.sqrt(dist_dot(a_loc, a_loc, spec))


def local_starts(spec: HaloSpec) -> Tuple[int, ...]:
    """Global starting index of this rank's block, per dim."""
    coords = spec.grid.coords
    return tuple(0 if ax.name is None else coords[a] * ax.n_loc
                 for a, ax in enumerate(spec.axes))


def gather_blocks(x_loc: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """Every rank's block assembled into the global (padded) field on every
    rank: one ``all_gather`` (the JAX package's tiled ``all_gather``)."""
    world = math.prod(grid.mesh_shape)
    grid.record("all_gather", x_loc.shape, x_loc.dtype)
    src = x_loc.contiguous()
    if grid.backend == "gloo":
        parts = [torch.empty_like(src, device="cpu") for _ in range(world)]
        dist.all_gather(parts, src.cpu(), group=grid.group)
        flat = torch.stack(parts).to(x_loc.device)
    else:
        flat = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                           device=src.device)
        dist.all_gather_into_tensor(flat, src, group=grid.group)
    nd = x_loc.ndim
    blocks = flat.reshape(tuple(grid.mesh_shape) + tuple(src.shape))
    # (m0, ..., n0, ...) -> (m0, n0, m1, n1, ...) -> (N0, N1, ...)
    order = [i for a in range(nd) for i in (a, nd + a)]
    return blocks.permute(order).reshape(
        tuple(m * n for m, n in zip(grid.mesh_shape, src.shape)))
