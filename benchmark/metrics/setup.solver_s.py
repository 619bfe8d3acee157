"""setup.solver_s: the benchmark's host clock around the solver step of
set-up, ended by a synchronize (see benchmark/harness.py::run)."""


def read(ctx):
    return ctx.setup["solver"]
