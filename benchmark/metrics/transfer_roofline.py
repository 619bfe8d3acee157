"""transfer_roofline: as kron_roofline, for K7, the restriction and the
prolongation with its add, called from mg/cycles.py."""
from benchmark.work import calls

SPANS = {"transfer": {"module": "poms_tpu_torch.mg.cycles",
                      "entry": "apply_transfer", "work": calls.apply_transfer,
                      "counters": ("transfer",)}}


def read(ctx):
    return ctx.roofline("transfer")
