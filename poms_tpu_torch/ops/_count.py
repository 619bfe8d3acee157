"""Launch counting shared by the kernel wrappers that take several dtypes.

A wrapper counts where it launches its kernel: ``wrapper.launches`` (one
integer, or one per mode) over every dtype, and
``wrapper.launches_by_dtype[name]`` (the same shape) for each instantiation,
``name`` one of ``f32``, ``f64``, ``bf16``.  :data:`BYTES` holds the counters
of bytes rather than launches.  :mod:`poms_tpu_torch.ops.counters` reads and
advances all of them.
"""
from __future__ import annotations

import torch

__all__ = ["DTYPE_NAMES", "BYTES", "attach", "count"]

DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16"}

# ``graph.copy_bytes``: what GraphedStep's copy-back moves, advanced at every
# replay (mg/graph.py); ``graph.inplace_bytes``: the state buffers a graph's
# step wrote in place and returned as themselves, advanced at every replay
# (mg/graph.py); ``kron.scratch_bytes``: the scratch of K1r and K5r
# plans, advanced where a plan allocates it (ops/kron.py::plan_scratch);
# ``kron.partial_bytes``: the partial sums K1 and K1r pass between the runs
# of terms of one call, written and read back (ops/kron.py::_count_partial),
# which a replay adds with its launches; ``kron.folded_terms`` (a count of
# terms, not bytes): the terms that K1's plans folded away, advanced where a
# plan is built (ops/kron.py::build_kron_plan)
BYTES = {"graph.copy_bytes": 0, "graph.inplace_bytes": 0,
         "kron.scratch_bytes": 0,
         "kron.partial_bytes": 0, "kron.folded_terms": 0}


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
