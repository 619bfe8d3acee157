"""Sparse × sparse products (SpGEMM) — vectorized host implementation.

Host copy of ``poms_tpu.sparse.spgemm`` (numpy only: importing the JAX
package imports jax).

SURVEY.md §2 C6: the reference uses SpMM/SpGEMM once per level to assemble
Galerkin coarse operators A_c = R·A·P.  This is a setup-time operation
(correctness > speed, SURVEY.md §7.2.4), so it runs on host in numpy using a
fully vectorized expand-then-coalesce scheme:

  1. each nonzero A[i,k] fans out over row k of B → COO triples
     (i, col_B, a*b) built with np.repeat + range concatenation
     (no Python loop over rows);
  2. duplicates are coalesced with np.unique on the flattened key.

Peak memory is O(total products), which for banded × banded is ~band² per
row — fine at setup sizes.  Verified against scipy's SMMP in tests.
"""
from __future__ import annotations

import numpy as np

from poms_tpu_torch.sparse.csr import CsrMatrix

__all__ = ["csr_spgemm", "rap"]


def _concat_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+c) ranges without a Python loop."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    # index i belongs to group g(i) = searchsorted(ends, i, 'right')
    idx = np.arange(total, dtype=np.int64)
    group = np.searchsorted(ends, idx, side="right")
    offset_in_group = idx - (ends[group] - counts[group])
    return starts[group] + offset_in_group


def csr_spgemm(A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """C = A @ B for host CSR matrices.

    Uses the native C++ SMMP kernel (sparse/cpp/spgemm.cpp, O(flops) memory)
    when available, else the vectorized numpy expand/coalesce fallback.
    """
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
    from poms_tpu_torch.sparse.native import csr_spgemm_native, native_available

    if native_available():
        Cp, Cj, Cx = csr_spgemm_native(
            A.indptr, A.indices, A.data, B.indptr, B.indices, B.data,
            A.shape[0], B.shape[1])
        return CsrMatrix(indptr=Cp, indices=Cj, data=Cx,
                         shape=(A.shape[0], B.shape[1]))
    a_rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), A.row_lengths())
    a_cols = A.indices
    a_vals = A.data
    b_counts = B.row_lengths()[a_cols]
    rows = np.repeat(a_rows, b_counts)
    av = np.repeat(a_vals, b_counts)
    b_idx = _concat_ranges(B.indptr[a_cols], b_counts)
    cols = B.indices[b_idx]
    vals = av * B.data[b_idx]
    return CsrMatrix.from_coo(rows, cols, vals, (A.shape[0], B.shape[1]))


def rap(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> CsrMatrix:
    """Galerkin triple product A_c = R · A · P (SURVEY.md §3.3)."""
    return csr_spgemm(csr_spgemm(R, A), P)
