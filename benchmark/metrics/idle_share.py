"""idle_share: 100·(1 − device busy time ÷ window) over whole replayed
solves under torch.profiler, the busy time the union of the device's
operations, the window by CUDA events (layer: device)."""


def read(ctx):
    if ctx.replay is None or ctx.replay["busy_s"] <= 0:
        return None                    # no operation ran on a device
    return 100.0 * (1.0 - ctx.replay["busy_s"] / ctx.replay["window_s"])
