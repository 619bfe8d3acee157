"""The work of one call into a layer of the program, read from the call's
arguments (shapes, half-width, dtype, mode): ``(bytes, operations,
dtype)`` through the functions of :mod:`benchmark.work`.  One function per
layer entry that the rooflines wrap; each knows that entry's signature."""
from __future__ import annotations

import math

from benchmark import work

__all__ = ["dtype_name", "kron_mode", "residual_kron_df", "stencil_apply",
           "apply_transfer"]


def dtype_name(t) -> str:
    return {"torch.float32": "f32", "torch.float64": "f64",
            "torch.bfloat16": "bf16"}[str(t.dtype)]


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def kron_mode(args, kwargs):
    """``poms_tpu_torch.ops.kron.kron_mode(mode, plan, x_int, b, d, ...)``,
    counted on the operator's own axes: its points ``plan.npts`` and the
    rows of its labels that the plan's lift to 3D did not add."""
    mode, plan, x = args[0], args[1], args[2]
    d = _arg(args, kwargs, 4, "d")
    nbytes, flops = work.kron(mode, plan.npts, max(plan.pads),
                              plan.labels[3 - plan.ndim:], x.element_size(),
                              first_cheb=d is None)
    return nbytes, flops, dtype_name(x)


def residual_kron_df(args, kwargs):
    """``residual_kron_df(terms_df, bh, bl, xh, xl, pads, labels=...)`` as
    ``mg/mixed.py`` calls it: the field's own shape and the sharing labels
    as given, one row an axis of 1, 2 or 3."""
    bh, xh, xl = args[1], args[3], args[4]
    pads = _arg(args, kwargs, 5, "pads")
    nbytes, flops = work.kron_dw(tuple(xh.shape), max(pads), kwargs["labels"],
                                 low_word=xl is not None, rhs=bh is not None)
    return nbytes, flops, "f32"


def stencil_apply(args, kwargs):
    """``stencil_apply(mode, band_t, x_pad, npts, pads, b=..., ...)``."""
    mode, band_t, x_pad, npts = args[0], args[1], args[2], args[3]
    n = math.prod(npts)
    nbytes, flops = work.stencil(
        mode, npts, band_t.numel() // n, band_t.numel(), x_pad.numel(),
        x_pad.element_size(), rhs=kwargs.get("b") is not None)
    return nbytes, flops, dtype_name(x_pad)


def apply_transfer(args, kwargs):
    """``apply_transfer(tbs, x, add=None)``: one 1D band per axis."""
    tbs, x = args[0], args[1]
    add = _arg(args, kwargs, 2, "add")
    n_in = tuple(x.shape)
    n_out = tuple(tb.n_out for tb in tbs)
    widths = tuple(tb.width for tb in tbs)
    nbytes, flops = work.transfer(n_in, n_out, widths, x.element_size(),
                                  add is not None)
    return nbytes, flops, dtype_name(x)
