"""stencil_roofline: as kron_roofline, for the banded engine the dispatch
selects (K2 by default), every mode and dtype."""
from benchmark.work import calls

SPANS = {"stencil": {"module": "poms_tpu_torch.ops.dispatch",
                     "entry": "stencil_apply", "work": calls.stencil_apply,
                     "counters": ("stencil_apply",)}}


def read(ctx):
    return ctx.roofline("stencil")
