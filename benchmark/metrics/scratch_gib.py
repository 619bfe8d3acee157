"""scratch_gib: the scratch of the K1r and K5r plans, the counter
kron.scratch_bytes of ops/counters.py (advanced only where set-up builds a
plan: no plan is built after it), in GiB.  None where the program has no
such counter or its plans hold no scratch."""


def read(ctx):
    from poms_tpu_torch.ops import counters

    held = counters.snapshot().get("kron.scratch_bytes")
    return held / 2 ** 30 if held else None
