"""solve_ms: the window's wall time over the solves completed in it."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.solves)
