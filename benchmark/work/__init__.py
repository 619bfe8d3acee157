"""The least work of the operations the rooflines are taken over, from the
shapes and half-width of a call, and the published peaks of the card.

Each count is of the operation, never of the kernel that implements it: every
input byte read once and every output byte written once, and the operations
of the cheapest order of 1D contractions that the operator's structure
allows.  A later kernel that does the same operation in another way is held
to the same work.  An FMA counts as two operations, as the peak counts it.
"""
from __future__ import annotations

import itertools
import math

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "least_s", "contractions",
           "kron", "kron_dw", "stencil", "transfer"]

# NVIDIA H100 SXM, data sheet, dense: HBM3 bandwidth; f32 and f64 outside
# the tensor cores (an FMA counts as two).  bf16 fields are computed in f32.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 67e12, "f64": 34e12}

# operations of one double-word product and one double-word sum of f32 pairs
# (Dekker's product with an FMA, the accurate pair sum), none of them fused
DW_MUL = 9
DW_ADD = 20


def least_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: bytes over the bandwidth or
    operations over the peak of ``dtype``, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def contractions(labels) -> int:
    """1D contractions of a sum of Kronecker products over d = len(labels)
    axes, whose band on axis a of term r has label ``labels[a][r]`` (equal
    labels, equal bands), in the order axis d−1, …, 0 with every shared
    partial product made once and the terms that share an axis-0 band
    summed before it: the distinct histories (labels on axes a … d−1) of
    each axis a ≥ 1, and the distinct axis-0 bands.  Poisson: 7 in 3D, 4 in
    2D, 1 in 1D."""
    d, terms = len(labels), range(len(labels[0]))
    return (sum(len({tuple(labels[b][r] for b in range(a, d))
                     for r in terms}) for a in range(1, d))
            + len({labels[0][r] for r in terms}))


def _bands_bytes(npts, labels, p, itemsize) -> int:
    """Each distinct band of each of the operator's own axes, once."""
    return sum(len(set(labels[a])) * npts[a] * (2 * p + 1) * itemsize
               for a in range(len(npts)))


# fields read and written by one Kronecker-sum pass in each mode, and the
# operations a point adds to the contractions: apply y = A x; residual
# b − A x; dinv D⁻¹ A x; cheb x' = x + d' with d' = c1·d + c2·D⁻¹(b − A x)
_KRON_FIELDS = {"apply": 2, "residual": 3, "dinv": 2, "cheb": 5}
_KRON_EPILOGUE = {"apply": 0, "residual": 1, "dinv": 1, "cheb": 6}


def kron(mode: str, npts, p: int, labels, itemsize: int,
         first_cheb: bool = False):
    """(bytes, operations) of one Kronecker-sum pass in ``mode`` over the
    field ``npts`` of 1, 2 or 3 axes (``labels`` one row an axis) with
    half-width ``p``; ``first_cheb``: the first
    Chebyshev step, which has no direction to read."""
    n = math.prod(npts)
    fields = _KRON_FIELDS[mode] - (1 if mode == "cheb" and first_cheb else 0)
    nbytes = fields * n * itemsize + _bands_bytes(npts, labels, p, itemsize)
    flops = (2 * (2 * p + 1) * contractions(labels)
             + _KRON_EPILOGUE[mode]) * n
    return nbytes, flops


def kron_dw(npts, p: int, labels, low_word: bool, rhs: bool):
    """(bytes, operations) of one double-word residual b − A x (``rhs``
    false: A x) over f32 pairs: x's pair (only its high word where
    ``low_word`` is false) and b's read once, the result's pair written
    once, the bands' pairs read once; each contraction a double-word product
    a tap and a double-word sum between taps, a sum per term added and for
    b − A x."""
    n = math.prod(npts)
    W = 2 * p + 1
    fields = (2 if low_word else 1) + (2 if rhs else 0) + 2
    nbytes = fields * n * 4 + 2 * _bands_bytes(npts, labels, p, 4)
    per_point = (contractions(labels) * (W * DW_MUL + (W - 1) * DW_ADD)
                 + (len(labels[0]) - 1 + (1 if rhs else 0)) * DW_ADD)
    return nbytes, per_point * n


def stencil(mode: str, npts, taps: int, band_numel: int, x_numel: int,
            itemsize: int, rhs: bool):
    """(bytes, operations) of one banded pass: the band, x (with its
    ghosts), b where the mode reads it and the result once; a multiply-add
    a tap and point (``rbgs``: on the half of the points of one colour)."""
    n = math.prod(npts)
    nbytes = (band_numel + x_numel + (n if rhs else 0) + n) * itemsize
    extra = {"spmv": 0, "residual": 1, "jacobi": 3, "rbgs": 3}[mode]
    flops = (2 * taps + extra) * n
    if mode == "rbgs":
        flops //= 2
    return nbytes, flops


def transfer(n_in, n_out, widths, itemsize: int, add: bool):
    """(bytes, operations) of a tensor-product transfer (restriction or
    prolongation, with the add of the coarse correction where ``add``):
    the input, the result and the added field once, the 1D weights once; a
    multiply-add a tap and output of each 1D stage, in the cheapest order
    of the axes."""
    nbytes = (math.prod(n_in) + math.prod(n_out) * (2 if add else 1)
              + sum(o * w for o, w in zip(n_out, widths))) * itemsize
    best = None
    for order in itertools.permutations(range(len(n_in))):
        shape = list(n_in)
        flops = 0
        for a in order:
            shape[a] = n_out[a]
            flops += 2 * widths[a] * math.prod(shape)
        best = flops if best is None else min(best, flops)
    return nbytes, best + (math.prod(n_out) if add else 0)
