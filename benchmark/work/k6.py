"""The least work of one call into K6r or K6u, read from the call's arguments:
``(bytes, operations, dtype)`` as :mod:`benchmark.work.calls` gives it.

Each operand is read once and each result written once, as the plain twins
``dw_dot_stack_plain`` and ``dw_update_plain`` take and return them: a
tensor passed twice (a norm's ``(xh, xl, xh, xl)``) is read once, a ``None``
low word not at all.  The operations are left out: at most a double-word
product and sum a point and field pair (29 f32 operations against 8 to 16
bytes) leave the least time at the bytes, 3.35 TB/s, five times or more.
"""
from __future__ import annotations

__all__ = ["reduce", "update"]

# fields each mode of dw_update returns (``dwrr`` without ``ap``: 2)
_UPDATE_OUT = {"cg": 6, "direction": 1, "defect": 2, "dwrr": 4, "div": 1,
               "mul": 1}


def _read_once(tensors) -> int:
    seen = {}
    for t in tensors:
        if t is not None:
            seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())


def reduce(args, kwargs):
    """``ops/twofloat.py::_reduce(pairs, plain, sqrt=False)``: k dots (or
    norms, or sums) of (xh, xl, yh, yl) f32 pairs → k f64 results."""
    pairs = args[0]
    nbytes = _read_once(t for pair in pairs for t in pair) + 8 * len(pairs)
    return nbytes, 0, "f32"


def update(args, kwargs):
    """``dw_update(mode, *ops)``: its fields and 0-dim f64 scalars read, its
    f32 results (each of the first field's size) written."""
    mode, ops = args[0], args[1:]
    n_out = _UPDATE_OUT[mode]
    if mode == "dwrr" and ops[3] is None:
        n_out = 2
    nbytes = _read_once(ops) + n_out * ops[0].numel() * 4
    return nbytes, 0, "f32"
