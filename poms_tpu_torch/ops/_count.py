"""Launch counting shared by the kernel wrappers that take several dtypes.

A wrapper counts where it launches its kernel: ``wrapper.launches`` (one
integer, or one per mode) over every dtype, and
``wrapper.launches_by_dtype[name]`` (the same shape) for each instantiation,
``name`` one of ``f32``, ``f64``, ``bf16``.  :mod:`poms_tpu_torch.ops.counters`
reads and advances both.
"""
from __future__ import annotations

import torch

__all__ = ["DTYPE_NAMES", "attach", "count"]

DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16"}


def attach(wrapper, modes=None) -> None:
    """Give ``wrapper`` its counters, at 0 (per mode when ``modes``)."""
    def zero():
        return 0 if modes is None else dict.fromkeys(modes, 0)

    wrapper.launches = zero()
    wrapper.launches_by_dtype = {name: zero()
                                 for name in DTYPE_NAMES.values()}


def count(wrapper, dtype: torch.dtype, mode=None) -> None:
    """One launch of ``wrapper``'s kernel in ``dtype`` (and ``mode``)."""
    name = DTYPE_NAMES[dtype]
    if mode is None:
        wrapper.launches += 1
        wrapper.launches_by_dtype[name] += 1
    else:
        wrapper.launches[mode] += 1
        wrapper.launches_by_dtype[name][mode] += 1
