"""Banded ("DIA-of-offsets") stencil matrices with sparse interchange.

Counterpart of ``poms_tpu.core.matrix.StencilMatrix``.  For each grid
multi-index ``i`` the (2p+1)^d band of nonzeros is stored by diagonal
offset, offset-major: ``band_t`` has shape ``band_shape + npts`` and
``band_t[k, i]`` multiplies ``x[i + k - p]``.  Each coefficient plane is a
contiguous grid-shaped array, which is what K2 streams
(:mod:`poms_tpu_torch.ops.stencil`).  ``band_t`` is kept contiguous on the
space's device in the space's dtype.

Conversions (COO/CSR/BSR/dense) run on the host in numpy, at setup and in
tests.  The hot path is :meth:`StencilMatrix.dot` →
:func:`poms_tpu_torch.ops.dispatch.spmv`.  Under the v2 engine
(``POMS_TPU_SPMV=v2``) :meth:`StencilMatrix.ensure_packed_v2` relays the
band out once for K3 (:func:`poms_tpu_torch.ops.stencil_v2.pack_band_v2`)
and :meth:`dot` and :meth:`residual` pass the pack on.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.ops import dispatch
from poms_tpu_torch.ops.stencil_v2 import pack_band_v2, stencil_apply_v2

__all__ = ["StencilMatrix"]


def _to_offset_major(band: torch.Tensor, nd: int) -> torch.Tensor:
    """(npts..., win...) → (win..., npts...)."""
    return band.permute(tuple(range(nd, 2 * nd)) + tuple(range(nd)))


class StencilMatrix:
    """Banded stencil operator mapping a space to itself.

    Rows whose stencil would reach outside a non-periodic domain must carry
    zeros there (the B-spline assembly guarantees it; :meth:`validate_boundary`
    checks it).
    """

    __slots__ = ("space", "band_t", "_packed_v2")

    def __init__(self, space: StencilVectorSpace, band=None, *, band_t=None):
        self.space = space
        nd = space.ndim
        if band_t is None and band is not None:
            band_t = _to_offset_major(
                torch.as_tensor(band, dtype=space.dtype, device=space.device),
                nd)
        if band_t is None:
            band_t = torch.zeros(space.band_shape + space.npts,
                                 dtype=space.dtype, device=space.device)
        self.band_t = torch.as_tensor(band_t, dtype=space.dtype,
                                      device=space.device).contiguous()
        self._packed_v2 = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_band(cls, space: StencilVectorSpace, band) -> "StencilMatrix":
        """From a grid-major ``(npts..., win...)`` band array."""
        band = torch.as_tensor(band, dtype=space.dtype, device=space.device)
        want = space.npts + space.band_shape
        if tuple(band.shape) != want:
            raise ValueError(f"band shape {tuple(band.shape)} != {want}")
        return cls(space, band)

    @classmethod
    def from_band_t(cls, space: StencilVectorSpace, band_t) -> "StencilMatrix":
        """From an offset-major ``(win..., npts...)`` band array."""
        band_t = torch.as_tensor(band_t, dtype=space.dtype,
                                 device=space.device)
        want = space.band_shape + space.npts
        if tuple(band_t.shape) != want:
            raise ValueError(f"band_t shape {tuple(band_t.shape)} != {want}")
        return cls(space, band_t=band_t)

    @property
    def band(self) -> torch.Tensor:
        """Grid-major view ``band[i, k]`` (construction and interchange
        only; the operational layout is :attr:`band_t`)."""
        return _to_offset_major(self.band_t, self.space.ndim)

    # -- linear-operator interface -----------------------------------------
    def ensure_packed_v2(self) -> "StencilMatrix":
        """Pack the band for K3 if the v2 engine is selected and it is not
        packed yet (a no-op otherwise).  Call at setup (hierarchy build,
        hierarchy cast): the pack is a full band relayout, and it is not
        refreshed if ``band_t`` is later changed in place."""
        if self._packed_v2 is None and dispatch.engine() is stencil_apply_v2:
            sp = self.space
            self._packed_v2 = pack_band_v2(self.band_t, sp.npts, sp.pads)
        return self

    @property
    def packed_v2(self):
        """The :func:`pack_band_v2` dict if :meth:`ensure_packed_v2`
        packed the band, else None (the v2 engine then packs per call)."""
        return self._packed_v2

    def dot(self, v: StencilVector) -> StencilVector:
        """y = A v: refresh the ghosts, then one banded SpMV (K2 or K3)."""
        sp = self.space
        vg = v.update_ghost_regions()
        out = dispatch.spmv(self.band_t, vg.data, sp.npts, sp.pads,
                            packed=self._packed_v2)
        return StencilVector.from_interior(sp, out)

    def __matmul__(self, v: StencilVector) -> StencilVector:
        return self.dot(v)

    def residual(self, x: StencilVector, b: StencilVector) -> torch.Tensor:
        """Interior of b − A x: one fused K2 (or K3) pass."""
        sp = self.space
        return dispatch.residual(self.band_t, x.update_ghost_regions().data,
                                 b.interior, sp.npts, sp.pads,
                                 packed=self._packed_v2)

    def diagonal(self) -> torch.Tensor:
        """Main diagonal as an interior-shaped array."""
        return self.band_t[tuple(self.space.pads)]

    # -- host-side interchange ---------------------------------------------
    def _coo_arrays(self):
        """(rows, cols, vals) over the flattened interior index space.

        Out-of-range entries wrap for periodic dims and are asserted zero,
        then dropped, for non-periodic dims.
        """
        sp = self.space
        band_t = self.band_t.detach().cpu().numpy()
        npts, pads, periodic = sp.npts, sp.pads, sp.periodic
        nd = sp.ndim
        grids = np.meshgrid(*[np.arange(n) for n in npts], indexing="ij")
        rows_md = [g.ravel() for g in grids]

        rows_l, cols_l, vals_l = [], [], []
        for k in itertools.product(*[range(2 * p + 1) for p in pads]):
            vals = band_t[k].ravel()
            cols_md = []
            valid = np.ones(vals.shape, bool)
            for a in range(nd):
                c = rows_md[a] + (k[a] - pads[a])
                if periodic[a]:
                    c = c % npts[a]
                else:
                    valid &= (c >= 0) & (c < npts[a])
                cols_md.append(c)
            rflat = np.zeros(vals.shape, np.int64)
            cflat = np.zeros(vals.shape, np.int64)
            for a in range(nd):
                rflat = rflat * npts[a] + rows_md[a]
                cflat = cflat * npts[a] + np.where(valid, cols_md[a], 0)
            oob = ~valid
            if oob.any() and np.abs(vals[oob]).max() > 0:
                raise ValueError(
                    "nonzero stencil coefficient reaches outside a "
                    "non-periodic domain — assembly bug")
            keep = valid & (vals != 0)
            rows_l.append(rflat[keep])
            cols_l.append(cflat[keep])
            vals_l.append(vals[keep])
        rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
        cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
        vals = np.concatenate(vals_l) if vals_l else np.zeros(0, band_t.dtype)
        return rows, cols, vals

    def tocoo(self):
        """scipy.sparse.coo_matrix over flattened interior indices."""
        import scipy.sparse as sps

        rows, cols, vals = self._coo_arrays()
        n = self.space.size
        return sps.coo_matrix((vals, (rows, cols)), shape=(n, n))

    def tocsr(self):
        return self.tocoo().tocsr()

    def tobsr(self, blocksize=None):
        """Native BSR storage (:class:`poms_tpu_torch.sparse.bsr.BsrMatrix`)
        built from the stencil's COO triplets.  Default block size: the last
        grid dim's band count (2·p_last + 1) if it tiles the matrix, else
        1×1."""
        from poms_tpu_torch.sparse.bsr import BsrMatrix

        n = self.space.size
        if blocksize is None:
            w = 2 * self.space.pads[-1] + 1
            b = w if n % w == 0 else 1
            blocksize = (b, b)
        rows, cols, vals = self._coo_arrays()
        return BsrMatrix.from_coo(rows, cols, vals, (n, n), blocksize)

    def toarray(self):
        return self.tocoo().toarray()

    @classmethod
    def from_coo(cls, space: StencilVectorSpace, rows, cols, vals,
                 tol: float = 0.0) -> "StencilMatrix":
        """Inverse of :meth:`tocoo`: scatter flat COO into the band.

        Entries outside the band raise (pads too small).  Duplicate
        (row, col) entries are summed.  ``tol`` first drops entries with
        |v| <= tol (a Galerkin RAP of nested spaces is exactly banded, but
        floating point leaves ~1e-16 outside the band).
        """
        sp = space
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if tol > 0.0:
            keep = np.abs(vals) > tol
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        nd, npts, pads = sp.ndim, sp.npts, sp.pads

        band_t = np.zeros(sp.band_shape + npts, np.float64)
        r_md, c_md = [], []
        r, c = rows.copy(), cols.copy()
        for a in reversed(range(nd)):
            r_md.insert(0, r % npts[a])
            r //= npts[a]
            c_md.insert(0, c % npts[a])
            c //= npts[a]
        k_md = []
        for a in range(nd):
            off = c_md[a] - r_md[a]
            if sp.periodic[a]:
                n = npts[a]
                off = (off + n // 2) % n - n // 2  # wrap to nearest
            k = off + pads[a]
            if ((k < 0) | (k >= 2 * pads[a] + 1)).any():
                raise ValueError(
                    f"COO entry outside band in dim {a}: pads={pads} too small")
            k_md.append(k)
        np.add.at(band_t, tuple(k_md) + tuple(r_md), vals)
        return cls(sp, band_t=torch.as_tensor(band_t))

    @classmethod
    def from_scipy(cls, space: StencilVectorSpace, mat) -> "StencilMatrix":
        coo = mat.tocoo()
        return cls.from_coo(space, coo.row, coo.col, coo.data)

    # -- structural ops ----------------------------------------------------
    def transpose(self) -> "StencilMatrix":
        """Aᵀ in the same band format."""
        rows, cols, vals = self._coo_arrays()
        return StencilMatrix.from_coo(self.space, cols, rows, vals)

    @property
    def T(self) -> "StencilMatrix":
        return self.transpose()

    def __add__(self, other: "StencilMatrix") -> "StencilMatrix":
        return StencilMatrix(self.space, band_t=self.band_t + other.band_t)

    def __mul__(self, scalar) -> "StencilMatrix":
        return StencilMatrix(self.space, band_t=self.band_t * scalar)

    __rmul__ = __mul__

    def validate_boundary(self) -> bool:
        """True iff no nonzero coefficient escapes a non-periodic boundary."""
        try:
            self._coo_arrays()
            return True
        except ValueError:
            return False

    def __repr__(self):
        return (f"StencilMatrix(npts={self.space.npts}, "
                f"band={self.space.band_shape})")
