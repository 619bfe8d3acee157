"""Banded-operator entry points: SpMV, fused residual, Jacobi sweep and one
red-black Gauss–Seidel colour phase.

Counterpart of ``poms_tpu/ops/dispatch.py`` (``spmv``, ``residual``,
``jacobi``, ``rbgs_color``).  Each is one pass of K2
(:func:`poms_tpu_torch.ops.stencil.stencil_apply`): the CUDA kernel for
tensors on the card, the plain version for tensors on the CPU.  The JAX
package's engine switches (``POMS_TPU_IMPL``, the TPU lane fold, the v2
engine) have no counterpart here.

All entry points take the offset-major band (``band_t[k..., i...]``).
"""
from __future__ import annotations

from poms_tpu_torch.ops.stencil import stencil_apply

__all__ = ["spmv", "residual", "jacobi", "rbgs_color"]


def spmv(band_t, x_pad, npts, pads):
    """out = A·x over the interior (x_pad's ghosts already filled)."""
    return stencil_apply("spmv", band_t, x_pad, npts, pads)


def residual(band_t, x_pad, b_int, npts, pads):
    """r = b − A·x in one pass."""
    return stencil_apply("residual", band_t, x_pad, npts, pads, b=b_int)


def jacobi(band_t, x_pad, b_int, omega, npts, pads):
    """x' = x + ω (b − A x)/diag in one pass."""
    return stencil_apply("jacobi", band_t, x_pad, npts, pads, b=b_int,
                         omega=omega)


def rbgs_color(band_t, x_pad, b_int, omega, color, npts, pads, starts=None):
    """One RB-GS colour phase: the hybrid-GS update on colour-``color``
    points (parity of the global index sum), the rest copied unchanged."""
    return stencil_apply("rbgs", band_t, x_pad, npts, pads, b=b_int,
                         omega=omega, color=color, starts=starts)
