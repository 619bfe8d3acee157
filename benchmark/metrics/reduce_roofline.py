"""reduce_roofline: as kron_roofline, for K6r, the double-word dots and
norms of the dw recurrences (ops/twofloat.py::_reduce, which dw_dot_stack,
dw_dot and dw_norm2 call on the card), against the bytes of each call
(benchmark/work/k6.py)."""
from benchmark.work import k6

SPANS = {"k6r": {"module": "poms_tpu_torch.ops.twofloat", "entry": "_reduce",
                 "work": k6.reduce, "counters": ("dw_reduce",)}}


def read(ctx):
    return ctx.roofline("k6r")
