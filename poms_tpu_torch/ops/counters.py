"""The launch counters of every kernel wrapper, read and advanced together.

Each wrapper counts where it launches its kernel.  A captured CUDA graph
launches the same kernels again at every replay without passing through the
wrappers, so the code that replays a graph adds the launches it captured
(:func:`diff` of two :func:`snapshot` s) with :func:`add`.
"""
from __future__ import annotations

from typing import Dict

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
_BY_MODE = {"kron_mode": kron_mode, "stencil_apply": stencil_apply,
            "stencil_apply_v2": stencil_apply_v2}


def snapshot() -> Dict[str, int]:
    """Every counter, the per-mode ones as ``name.mode``."""
    out = {name: fn.launches for name, fn in _PLAIN.items()}
    for name, fn in _BY_MODE.items():
        out.update({f"{name}.{m}": n for m, n in fn.launches.items()})
    return out


def diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add(delta: Dict[str, int]) -> None:
    """Advance the counters by ``delta`` (keys as :func:`snapshot`'s)."""
    for key, n in delta.items():
        name, _, mode = key.partition(".")
        if mode:
            _BY_MODE[name].launches[mode] += n
        else:
            _PLAIN[name].launches += n


def reset() -> None:
    add({k: -n for k, n in snapshot().items()})
