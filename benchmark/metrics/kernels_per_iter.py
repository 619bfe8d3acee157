"""kernels_per_iter: the hand-written kernels launched in the window
(ops/counters.py, a graph replay adding its captured launches), over the
window's iterations (layer: graph replay)."""
from benchmark.harness import hand_kernels


def read(ctx):
    launched = hand_kernels(ctx.window_counters)
    if not ctx.iterations or not launched:     # the CPU launches none
        return None
    return launched / ctx.iterations
