"""iter_ms: the window's wall time over all its iterations (layer: graph
replay, mg/graph.py)."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.iterations if ctx.iterations else None
