"""kron_roofline: the least time of every call into K1 / K1r (the
Kronecker-sum apply and its fused modes, reached through core/kron.py) in a
few eager steps of the cell's solver, over the device time of the kernels
those calls launched, in percent."""
from benchmark.work import calls

SPANS = {"kron": {"module": "poms_tpu_torch.core.kron", "entry": "kron_mode",
                  "work": calls.kron_mode, "counters": ("kron_mode",)}}


def read(ctx):
    return ctx.roofline("kron")
