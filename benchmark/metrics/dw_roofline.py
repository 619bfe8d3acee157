"""dw_roofline: as kron_roofline, for K5 / K5r, the double-word residual or
A·p that mg/mixed.py calls.  Its operations are f32 adds and multiplies that
may not fuse, so against the 67 TFLOP/s peak (an FMA counted as two) it
reads at most about 50%."""
from benchmark.work import calls

SPANS = {"dw": {"module": "poms_tpu_torch.mg.mixed",
                "entry": "residual_kron_df", "work": calls.residual_kron_df,
                "counters": ("residual_kron_df",)}}


def read(ctx):
    return ctx.roofline("dw")
