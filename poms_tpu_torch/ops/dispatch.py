"""Banded-operator entry points: SpMV, fused residual, Jacobi sweep and one
red-black Gauss–Seidel colour phase.

Counterpart of ``poms_tpu/ops/dispatch.py`` (``spmv``, ``residual``,
``jacobi``, ``rbgs_color``).  Each is one pass of the engine that
:func:`engine` selects, as ``poms_tpu/ops/pallas/spmv.py::_engine`` does:
``POMS_TPU_SPMV=v2`` selects K3
(:func:`poms_tpu_torch.ops.stencil_v2.stencil_apply_v2`, over the band
packed once per operator and passed as ``packed``), anything else K2
(:func:`poms_tpu_torch.ops.stencil.stencil_apply`, which ignores
``packed``).  Either runs its CUDA kernel for tensors on the card (or
raises: K3 never falls back to K2) and its plain version for tensors on
the CPU.  The JAX package's other switches (``POMS_TPU_IMPL``, the TPU
lane fold) have no counterpart here.

All entry points take the offset-major band (``band_t[k..., i...]``).
"""
from __future__ import annotations

import os

from poms_tpu_torch.ops.stencil import stencil_apply
from poms_tpu_torch.ops.stencil_v2 import stencil_apply_v2

__all__ = ["engine", "spmv", "residual", "jacobi", "rbgs_color"]


def engine():
    """The banded kernel engine: K3 under ``POMS_TPU_SPMV=v2``, else K2."""
    return (stencil_apply_v2 if os.environ.get("POMS_TPU_SPMV") == "v2"
            else stencil_apply)


def _apply(mode, band_t, x_pad, npts, pads, packed, **kw):
    call = engine()
    if call is stencil_apply_v2:
        return call(mode, band_t, x_pad, npts, pads, packed=packed, **kw)
    return call(mode, band_t, x_pad, npts, pads, **kw)


def spmv(band_t, x_pad, npts, pads, packed=None):
    """out = A·x over the interior (x_pad's ghosts already filled).
    ``packed``: the operator's ``pack_band_v2`` (v2 engine)."""
    return _apply("spmv", band_t, x_pad, npts, pads, packed)


def residual(band_t, x_pad, b_int, npts, pads, packed=None):
    """r = b − A·x in one pass."""
    return _apply("residual", band_t, x_pad, npts, pads, packed, b=b_int)


def jacobi(band_t, x_pad, b_int, omega, npts, pads, packed=None):
    """x' = x + ω (b − A x)/diag in one pass."""
    return _apply("jacobi", band_t, x_pad, npts, pads, packed, b=b_int,
                  omega=omega)


def rbgs_color(band_t, x_pad, b_int, omega, color, npts, pads, starts=None,
               packed=None):
    """One RB-GS colour phase: the hybrid-GS update on colour-``color``
    points (parity of the global index sum), the rest copied unchanged."""
    return _apply("rbgs", band_t, x_pad, npts, pads, packed, b=b_int,
                  omega=omega, color=color, starts=starts)
