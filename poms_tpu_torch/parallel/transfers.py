"""Distributed banded transfers: a halo exchange, then K7 on the block.

Counterpart of ``poms_tpu/parallel/transfers.py``.  Padded global sizes
satisfy ``N_f = 2 · N_c`` per dim, so rank d owns coarse rows
``[d·n_c, (d+1)·n_c)`` and exactly their image ``[2d·n_c, 2(d+1)·n_c)`` on
the fine level, and every transfer row reads only a ±W neighbour halo:

    restrict:  b_c[i] = Σ_t wR[I, t] · r_f[c0R[I] + t],  I = d·n_c + i
    prolong :  e_f[i] = Σ_t wP[I, t] · x_c[c0P[I] + t],  I = 2d·n_c + i

The JAX package exchanges the partial of each axis in turn and gathers in
``jnp``.  Here the source block is exchanged once on every dim, each to its
own width W (corners included), and the rank's rows of every axis' table
become a :class:`~poms_tpu_torch.ops.transfer.TransferBand` whose ``c0``
indexes the exchanged block: one K7 launch (``ops/transfer.py``) applies the
whole transfer, axis 0 first as in the JAX package.  A halo row of a later
axis is the neighbour's source row, which the earlier axes contract with
the same weights (the neighbour shares this rank's block range on them), so
each output equals the JAX package's term for term.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from poms_tpu_torch.ops.transfer import TransferBand, apply_transfer
from poms_tpu_torch.parallel.halo import (AxisSpec, HaloSpec, RankGrid,
                                          pad_and_exchange)

__all__ = ["DistTransfer1D", "build_dist_transfer", "dist_apply_transfer",
           "rank_transfer_operands"]


@dataclass(eq=False)
class DistTransfer1D:
    """One axis of a distributed banded transfer.

    ``w``: (N_out_global, W) f64 weights (zero rows for grid padding);
    ``c0``: (N_out_global,) global source start per output row (negative or
    past the end on a periodic axis: the taps wrap into the ghosts);
    ``n_out_loc`` / ``n_src_loc``: the block extents; ``halo`` = W."""
    w: np.ndarray
    c0: np.ndarray
    n_out_loc: int
    n_src_loc: int
    halo: int
    _local: dict = field(default_factory=dict, repr=False)

    def local_band(self, coord: int, dtype: torch.dtype,
                   device) -> TransferBand:
        """The rows of the block at ``coord`` as a band over the source
        block exchanged to width ``halo`` (n_src_loc + 2·halo rows).

        A window is moved inside the block where it would start before it
        or end past it; the taps it drops must be zero (raises otherwise).
        All-zero rows (grid padding) keep the previous row's start."""
        key = (coord, dtype, torch.device(device))
        if key in self._local:
            return self._local[key]
        W, h = self.w.shape[1], self.halo
        rows = coord * self.n_out_loc + np.arange(self.n_out_loc)
        n_in = self.n_src_loc + 2 * h
        if n_in < W:
            raise ValueError(f"a block of {self.n_src_loc} rows cannot hold "
                             f"a transfer of {W} taps")
        c0 = self.c0[rows] - coord * self.n_src_loc + h
        w = self.w[rows]
        start = np.clip(c0, 0, n_in - W)
        shift = start - c0
        t = np.arange(W)[None, :] + shift[:, None]
        keep = (t >= 0) & (t < W)
        w_new = np.where(keep, np.take_along_axis(w, np.clip(t, 0, W - 1),
                                                  1), 0.0)
        if np.any((w != 0).sum(1) != (w_new != 0).sum(1)):
            raise ValueError("a transfer row reads past the exchanged block")
        live = (w != 0).any(1)
        last = np.maximum.accumulate(np.where(live, np.arange(len(rows)), 0))
        start = np.where(live, start, start[last])
        band = TransferBand(w=torch.as_tensor(w_new, dtype=dtype,
                                              device=device),
                            c0=torch.as_tensor(start, dtype=torch.int64,
                                               device=device),
                            n_in=n_in)
        self._local[key] = band
        return band


def build_dist_transfer(P_like: np.ndarray, n_out_pad: int, n_src_pad: int,
                        m: int, periodic: bool = False) -> DistTransfer1D:
    """From a dense (n_out, n_src) operator to the distributed band form
    (the JAX package's construction, on the host in f64).

    ``n_out_pad``/``n_src_pad``: padded global sizes (multiples of ``m``).
    Rows and columns beyond the true sizes get zero weights.  ``periodic``:
    the columns of a wrapping row are unwrapped to a window around the row's
    centre (c0 may be negative or pass n_src − 1); periodic dims are never
    grid-padded."""
    P_like = np.asarray(P_like, dtype=np.float64)
    n_out, n_src = P_like.shape
    if periodic:
        if n_out_pad != n_out or n_src_pad != n_src:
            raise ValueError("periodic transfers cannot be grid-padded")
        ratio = n_src / n_out
        cols = np.arange(n_src)[None, :]
        center = np.rint(np.arange(n_out) * ratio).astype(np.int64)[:, None]
        rep = (cols - center + n_src // 2) % n_src + center - n_src // 2
        nz = np.abs(P_like) > 0
        first = np.where(nz, rep, np.iinfo(np.int64).max).min(1)
        last = np.where(nz, rep, np.iinfo(np.int64).min).max(1)
        first = np.where(nz.any(1), first, 0)
        last = np.where(nz.any(1), last, 0)
        W = max(1, int((last - first + 1).max()))
        c0 = first.astype(np.int64)
        w = np.zeros((n_out, W))
        rows = np.arange(n_out)
        for t in range(W):
            src = (c0 + t) % n_src
            val = P_like[rows, src]
            w[:, t] = np.where(rep[rows, src] == c0 + t, val, 0.0)
        return DistTransfer1D(w=w, c0=c0, n_out_loc=n_out // m,
                              n_src_loc=n_src // m, halo=W)
    nz = np.abs(P_like) > 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n_src - 1 - nz[:, ::-1].argmax(1), 0)
    W = max(1, int((last - first + 1).max()))
    c0 = np.zeros(n_out_pad, np.int64)
    w = np.zeros((n_out_pad, W))
    c0[:n_out] = np.minimum(first, np.maximum(0, n_src - W))
    for t in range(W):
        idx = np.minimum(c0[:n_out] + t, n_src - 1)
        valid = c0[:n_out] + t < n_src
        w[:n_out, t] = np.where(valid, P_like[np.arange(n_out), idx], 0.0)
    return DistTransfer1D(w=w, c0=c0, n_out_loc=n_out_pad // m,
                          n_src_loc=n_src_pad // m, halo=W)


def dist_apply_transfer(tbs: Sequence[DistTransfer1D], x_loc: torch.Tensor,
                        src_spec_axes: Tuple[AxisSpec, ...], grid: RankGrid,
                        add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply per-axis distributed transfers to the rank's block (plus
    ``add``, the prolongation's x + P·x_c).

    ``src_spec_axes``: the HaloSpec axes of the source level (names, sizes
    and periodic flags; extents and pads are the transfer's)."""
    bands, x_pad = rank_transfer_operands(tbs, x_loc, src_spec_axes, grid)
    return apply_transfer(bands, x_pad, add=add)


def rank_transfer_operands(tbs: Sequence[DistTransfer1D], x_loc: torch.Tensor,
                           src_spec_axes: Tuple[AxisSpec, ...],
                           grid: RankGrid):
    """(the rank's TransferBands, the source block exchanged to their
    widths): what :func:`dist_apply_transfer` hands K7 (an exchange, so
    every rank of the grid calls it)."""
    axes = tuple(AxisSpec(name=ax.name, size=ax.size, n_loc=x_loc.shape[a],
                          pad=tb.halo, periodic=ax.periodic)
                 for a, (ax, tb) in enumerate(zip(src_spec_axes, tbs)))
    x_pad = pad_and_exchange(x_loc, HaloSpec(axes=axes, grid=grid))
    coords = grid.coords
    bands = tuple(tb.local_band(0 if ax.name is None else coords[a],
                                x_loc.dtype, x_loc.device)
                  for a, (ax, tb) in enumerate(zip(axes, tbs)))
    return bands, x_pad
