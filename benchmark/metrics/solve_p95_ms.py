"""solve_p95_ms: the 95th percentile of every solve's wall time in the
window, each timed on the host clock and ended by a synchronize."""
from benchmark.harness import quantile


def read(ctx):
    return 1e3 * quantile([s[0] for s in ctx.solves], 0.95)
