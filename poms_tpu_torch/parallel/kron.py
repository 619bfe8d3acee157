"""Distributed Kronecker-sum operator: apply, double-word residual, norm.

Counterpart of ``poms_tpu/parallel/kron.py``.  The apply is a chain of
per-axis 1D banded contractions; distribution adds a width-p halo exchange
and, per axis, the rank's rows of the (replicated, small) global 1D band.
The JAX package computes the contractions in ``jnp``, outside any Pallas
kernel, and so does this module in plain PyTorch, in the serial port's
order (``ops/kron.py::apply_band_1d_axis``,
``ops/twofloat.py::_apply_band_1d_axis_df``).  The global norm of a
double-word residual is K6r (``ops/twofloat.py::dw_dot``) on the rank's
words, then one f64 ``all_reduce``.

Grid padding follows ``parallel/dist.py``: padded 1D band rows are identity
(centre 1), padded entries of x are zero, and every apply and smoothing
sweep keeps both.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from poms_tpu_torch.ops.twofloat import dw_add, dw_dot, dw_mul
from poms_tpu_torch.parallel.halo import (AxisSpec, HaloSpec, _pad,
                                          all_reduce_sum, halo_exchange,
                                          local_starts, pad_and_exchange)

__all__ = ["pad_band_1d_identity", "dist_kron_apply", "dist_kron_diag",
           "exchange_axis", "dist_kron_residual_df", "dist_dw_norm2"]


def pad_band_1d_identity(B: np.ndarray, N: int) -> np.ndarray:
    """Pad a 1D band (n, 2p+1) to (N, 2p+1) with identity rows: padded grid
    entries stay decoupled and the padded region has a unit diagonal."""
    B = np.asarray(B)
    n, w = B.shape
    if N == n:
        return B
    out = np.zeros((N, w), B.dtype)
    out[:n] = B
    out[n:, (w - 1) // 2] = 1.0
    return out


def exchange_axis(x_loc: torch.Tensor, a: int, ax: AxisSpec,
                  spec: HaloSpec) -> torch.Tensor:
    """Pad and exchange the rank's block along axis ``a`` only (width
    ``ax.pad``); ``spec`` gives the grid."""
    axes = tuple(
        AxisSpec(name=ax.name if b == a else None,
                 size=ax.size if b == a else 1,
                 n_loc=x_loc.shape[b],
                 pad=ax.pad if b == a else 0,
                 periodic=ax.periodic if b == a else False)
        for b in range(x_loc.ndim))
    return halo_exchange(_pad(x_loc, [ax.pad if b == a else 0
                                      for b in range(x_loc.ndim)]),
                         HaloSpec(axes=axes, grid=spec.grid))


def _axis_contract(band_glob, x_pad, a: int, n_loc: int, start: int):
    """y[..., i, ...] = Σ_t B[start+i, t] · x_pad[..., i+t, ...] (x_pad
    exchanged along axis ``a``; any extent on the other axes)."""
    B = band_glob.narrow(0, start, n_loc)
    bshape = [1] * x_pad.ndim
    bshape[a] = n_loc
    out = None
    for t in range(B.shape[1]):
        term = B[:, t].reshape(bshape) * x_pad.narrow(a, t, n_loc)
        out = term if out is None else out + term
    return out


def _axis_contract_df(band_df_glob, xph, xpl, a: int, n_loc: int,
                      start: int):
    """Double-word twin of :func:`_axis_contract`."""
    Bh, Bl = (B.narrow(0, start, n_loc) for B in band_df_glob)
    bshape = [1] * xph.ndim
    bshape[a] = n_loc
    oh = ol = None
    for t in range(Bh.shape[1]):
        th, tl = dw_mul(Bh[:, t].reshape(bshape), Bl[:, t].reshape(bshape),
                        xph.narrow(a, t, n_loc), xpl.narrow(a, t, n_loc))
        if oh is None:
            oh, ol = th, tl
        else:
            oh, ol = dw_add(oh, ol, th, tl)
    return oh, ol


def _contract_terms(labels, partials, contract, exchange=None):
    """Axis passes right to left over the terms, one contraction per
    distinct (history, band) and, per axis, one exchange per distinct
    partial when ``exchange`` is given (the per-axis form)."""
    d = len(labels)
    n_terms = len(labels[0])
    hist = {r: () for r in range(n_terms)}
    for a in range(d - 1, -1, -1):
        ex_cache, cache = {}, {}
        for r in range(n_terms):
            src = partials[r]
            if exchange is not None:
                if hist[r] not in ex_cache:
                    ex_cache[hist[r]] = exchange(src, a)
                src = ex_cache[hist[r]]
            key = hist[r] + (labels[a][r],)
            if key not in cache:
                cache[key] = contract(a, labels[a][r], src)
            partials[r] = cache[key]
            hist[r] = key
    return [partials[r] for r in range(n_terms)]


def dist_kron_apply(bands_by_axis: Sequence[Sequence[torch.Tensor]],
                    labels: Sequence[Sequence[int]], x_loc: torch.Tensor,
                    spec: HaloSpec, fused: bool = True) -> torch.Tensor:
    """(Σ_r ⊗_a B^(a)_{labels[a][r]})·x on the rank's block.

    ``bands_by_axis[a]``: the distinct padded global 1D bands of axis a;
    ``labels[a][r]`` picks term r's.  ``fused=True``: one exchange of x on
    every dim up front, the earlier axes contracted over the later dims'
    halo rows (a halo row of dim b is the neighbour's interior, which
    shares this rank's range on the other dims), the form
    ``DistributedMG`` runs and ``bench/scaling_model.py``'s census counts;
    ``fused=False``: one exchange per distinct partial per axis, the JAX
    package's form.  The per-axis form exists only as a test reference: no
    solver path takes it, and the tests hold the fused form to it (the same
    bits) and count its exchanges against the JAX package's."""
    starts = local_starts(spec)
    n_loc = spec.n_loc

    def contract(a, lab, src):
        return _axis_contract(bands_by_axis[a][lab], src, a, n_loc[a],
                              starts[a])

    n_terms = len(labels[0])
    if fused:
        x_pad = pad_and_exchange(x_loc, spec)
        parts = _contract_terms(labels, {r: x_pad for r in range(n_terms)},
                                contract)
    else:
        parts = _contract_terms(
            labels, {r: x_loc for r in range(n_terms)}, contract,
            lambda src, a: exchange_axis(src, a, spec.axes[a], spec))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def dist_kron_residual_df(bands_df_by_axis, labels, bh, bl, xh, xl,
                          spec: HaloSpec, fused: bool = True):
    """r = b − A·x in double-word f32 on the rank's block (the distributed
    twin of ``ops/twofloat.py::residual_kron_df_plain``); the hi and lo
    words are exchanged separately (a message is exact).

    ``bands_df_by_axis[a]``: (hi, lo) f32 pairs of the distinct padded
    global 1D bands of axis a; ``fused`` as in :func:`dist_kron_apply`:
    ``True`` is what ``DistributedMG``'s twofloat residual runs, and
    ``False``, the per-axis form, exists only as a test reference."""
    starts = local_starts(spec)
    n_loc = spec.n_loc

    def contract(a, lab, src):
        return _axis_contract_df(bands_df_by_axis[a][lab], src[0], src[1],
                                 a, n_loc[a], starts[a])

    n_terms = len(labels[0])
    if fused:
        xp = (pad_and_exchange(xh, spec), pad_and_exchange(xl, spec))
        parts = _contract_terms(labels, {r: xp for r in range(n_terms)},
                                contract)
    else:
        parts = _contract_terms(
            labels, {r: (xh, xl) for r in range(n_terms)}, contract,
            lambda src, a: tuple(exchange_axis(t, a, spec.axes[a], spec)
                                 for t in src))
    axh, axl = parts[0]
    for ph, plo in parts[1:]:
        axh, axl = dw_add(axh, axl, ph, plo)
    return dw_add(bh, bl, -axh, -axl)


def dist_dw_norm2(rh, rl, spec: HaloSpec) -> torch.Tensor:
    """Global ‖r‖₂ of a distributed double-word field: K6r's sum of squares
    on the rank's words (one launch on the card), one f64 ``all_reduce``,
    the square root in f64."""
    local = dw_dot(rh, rl, rh, rl)
    total = all_reduce_sum(local, spec.grid) if spec.names else local
    return torch.sqrt(total)


def dist_kron_diag(bands_by_axis, labels, spec: HaloSpec) -> torch.Tensor:
    """The rank's block of diag(Σ ⊗B) = Σ ⊗diag(B) (no message)."""
    starts = local_starts(spec)
    out = None
    for r in range(len(labels[0])):
        dr = None
        for a, ax in enumerate(spec.axes):
            B = bands_by_axis[a][labels[a][r]]
            d1 = B[:, (B.shape[1] - 1) // 2].narrow(0, starts[a], ax.n_loc)
            dr = d1 if dr is None else torch.tensordot(dr, d1, dims=0)
        out = dr if out is None else out + dr
    return out
