"""copy_gb_per_iter: the bytes GraphedStep's copy-back moved in the window
(the counter graph.copy_bytes of ops/counters.py, which every replay
advances by the bytes reckoned at capture), in GB (1e9), over the window's
iterations (layer: graph replay, mg/graph.py).  None where the program has
no such counter or replayed no graph."""


def read(ctx):
    moved = ctx.window_counters.get("graph.copy_bytes")
    if not moved or not ctx.iterations:
        return None
    return moved / ctx.iterations / 1e9
