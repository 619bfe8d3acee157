"""setup_s: from the start of the process to the first timed solve: imports,
problem, hierarchy and λ estimates, kernel loading (and building, on a
checkout's first run), the right-hand sides and the first solve (warm-up
and graph capture)."""


def read(ctx):
    return ctx.setup["total"]
