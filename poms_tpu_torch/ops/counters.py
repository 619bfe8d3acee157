"""The launch counters of every kernel wrapper, read and advanced together.

Each wrapper counts where it launches its kernel.  A captured CUDA graph
launches the same kernels again at every replay without passing through the
wrappers, so the code that replays a graph adds the launches it captured
(:func:`diff` of two :func:`snapshot` s) with :func:`add`.

Keys: ``name`` or ``name.mode`` for a wrapper's count over every dtype, and
``name@dtype`` or ``name.mode@dtype`` (dtype one of f32, f64, bf16) for one
instantiation of a wrapper that takes several
(:mod:`poms_tpu_torch.ops._count`); ``kron_mode_rt.mode.pass`` and
``residual_kron_df_rt.pass`` count the passes (A, B, C) of the run-time
kernels K1r and K5r, whose launches ``kron_mode`` and ``residual_kron_df``
count as well.  Four keys count bytes, not launches: ``graph.copy_bytes``,
the copy-back of :class:`~poms_tpu_torch.mg.graph.GraphedStep` (its replays
add it with their launches), ``graph.inplace_bytes``, the state buffers its
step wrote in place instead (added likewise), ``kron.scratch_bytes``, the
scratch allocated for K1r and K5r plans (``ops/kron.py::plan_scratch``), and
``kron.partial_bytes``, the partial sums that K1 and K1r write and read back
between the runs of terms of one call (``ops/kron.py::_count_partial``; a
replay adds what its capture counted).  ``kron.folded_terms`` counts the
terms that K1's plans folded away where they were built
(``ops/kron.py::build_kron_plan``; 1 for a 3D periodic shifted operator, 0
for a Dirichlet one).
"""
from __future__ import annotations

from typing import Dict

from poms_tpu_torch.ops._count import BYTES
from poms_tpu_torch.ops.kron import kron_apply, kron_mode
from poms_tpu_torch.ops.stencil import stencil_apply
from poms_tpu_torch.ops.stencil_v2 import stencil_apply_v2
from poms_tpu_torch.ops.transfer import apply_transfer
from poms_tpu_torch.ops.twofloat import (dw_dot_stack, dw_update,
                                         residual_kron_df)

__all__ = ["snapshot", "diff", "add", "reset"]

# wrappers whose ``launches`` is one integer, and those counting per mode
_PLAIN = {"kron_apply": kron_apply, "residual_kron_df": residual_kron_df,
          "dw_reduce": dw_dot_stack, "dw_update": dw_update,
          "transfer": apply_transfer}
_BY_MODE = {"kron_mode": kron_mode, "kron_mode_rt": kron_mode.runtime,
            "residual_kron_df_rt": residual_kron_df.runtime,
            "stencil_apply": stencil_apply,
            "stencil_apply_v2": stencil_apply_v2}


def snapshot() -> Dict[str, int]:
    """Every counter (see the module docstring for the keys)."""
    out = {name: fn.launches for name, fn in _PLAIN.items()}
    for name, fn in _BY_MODE.items():
        out.update({f"{name}.{m}": n for m, n in fn.launches.items()})
        for dt, per_mode in fn.launches_by_dtype.items():
            out.update({f"{name}.{m}@{dt}": n for m, n in per_mode.items()})
    out.update({f"transfer@{dt}": n
                for dt, n in apply_transfer.launches_by_dtype.items()})
    out.update(BYTES)
    return out


def diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add(delta: Dict[str, int]) -> None:
    """Advance the counters by ``delta`` (keys as :func:`snapshot`'s)."""
    for key, n in delta.items():
        if key in BYTES:
            BYTES[key] += n
            continue
        key, _, dt = key.partition("@")
        name, _, mode = key.partition(".")
        fn = _BY_MODE[name] if mode else _PLAIN[name]
        counts = fn.launches_by_dtype if dt else fn
        if mode:
            (counts[dt] if dt else counts.launches)[mode] += n
        elif dt:
            counts[dt] += n
        else:
            fn.launches += n


def reset() -> None:
    add({k: -n for k, n in snapshot().items()})
