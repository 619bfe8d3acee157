"""Restriction / prolongation application — banded per-axis gathers.

Counterpart of ``poms_tpu.ops.transfer``: a tensor-product transfer
P = ⊗_a P_1^(a) is applied one axis at a time, each 1D application being

    y[..., i, ...] = Σ_t  w[i, t] · x[..., c0[i] + t, ...]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["TransferBand", "bands_from_dense", "apply_transfer_axis",
           "apply_transfer"]


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
                     device="cpu") -> TransferBand:
    """Extract the banded form of a dense (n_out, n_in) transfer matrix."""
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


def apply_transfer(tbs: Tuple[TransferBand, ...],
                   x: torch.Tensor) -> torch.Tensor:
    """Apply per-axis banded transfers (tensor-product operator) to x."""
    for a, tb in enumerate(tbs):
        x = apply_transfer_axis(tb, x, a)
    return x
