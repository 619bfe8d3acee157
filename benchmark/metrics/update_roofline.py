"""update_roofline: as kron_roofline, for K6u, the elementwise recurrences
that mg/mixed.py calls (dw_update in every mode), against the bytes of each
call (benchmark/work/k6.py)."""
from benchmark.work import k6

SPANS = {"k6u": {"module": "poms_tpu_torch.mg.mixed", "entry": "dw_update",
                 "work": k6.update, "counters": ("dw_update",)}}


def read(ctx):
    return ctx.roofline("k6u")
