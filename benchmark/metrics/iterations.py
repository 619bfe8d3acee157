"""iterations: the count solve_compiled returns, averaged over the window's
solves (layer: driver, mg/mixed.py)."""


def read(ctx):
    return ctx.iterations / len(ctx.solves)
