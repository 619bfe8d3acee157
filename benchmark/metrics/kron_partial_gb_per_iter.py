"""kron_partial_gb_per_iter: the partial sums that K1 and K1r wrote and read
back between the runs of terms of their calls in the window (the counter
kron.partial_bytes of ops/counters.py, which every replay advances by what
its capture counted), in GB (1e9), over the window's iterations (layer: K1
and K1r, ops/kron.py).  None where the program has no such counter or
counted none: an operator whose terms fit one launch writes no partial
sum."""


def read(ctx):
    moved = ctx.window_counters.get("kron.partial_bytes")
    if not moved or not ctx.iterations:
        return None
    return moved / ctx.iterations / 1e9
