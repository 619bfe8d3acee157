"""Minimal host-side CSR container (interchange + oracle format).

Host copy of ``poms_tpu.sparse.csr`` (numpy only: importing the JAX
package imports jax).

SURVEY.md §2 C4/§7.0: CSR/COO exist for scipy interop and setup-time
SpGEMM; the hot operator format is the banded stencil
(:class:`poms_tpu_torch.core.matrix.StencilMatrix`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["CsrMatrix"]


@dataclass
class CsrMatrix:
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "CsrMatrix":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # coalesce duplicates
        if len(rows):
            key_same = np.concatenate(
                [[False], (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])])
            group = np.cumsum(~key_same) - 1
            n_groups = group[-1] + 1
            r = np.zeros(n_groups, np.int64)
            c = np.zeros(n_groups, np.int64)
            v = np.zeros(n_groups, np.float64)
            np.add.at(v, group, vals)
            r[group] = rows
            c[group] = cols
            rows, cols, vals = r, c, v
        indptr = np.zeros(shape[0] + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=cols, data=vals, shape=tuple(shape))

    @classmethod
    def from_scipy(cls, m) -> "CsrMatrix":
        m = m.tocsr()
        return cls(indptr=np.asarray(m.indptr, np.int64),
                   indices=np.asarray(m.indices, np.int64),
                   data=np.asarray(m.data, np.float64),
                   shape=tuple(m.shape))

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix((self.data, self.indices, self.indptr),
                              shape=self.shape)

    @property
    def nnz(self) -> int:
        return len(self.data)

    def row_lengths(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Reference CSR mat-vec (vectorized numpy, host)."""
        x = np.asarray(x)
        prod = self.data * x[self.indices]
        out = np.zeros(self.shape[0], prod.dtype)
        rows = np.repeat(np.arange(self.shape[0]), self.row_lengths())
        np.add.at(out, rows, prod)
        return out

    def transpose(self) -> "CsrMatrix":
        rows = np.repeat(np.arange(self.shape[0]), self.row_lengths())
        return CsrMatrix.from_coo(self.indices, rows, self.data,
                                  (self.shape[1], self.shape[0]))
