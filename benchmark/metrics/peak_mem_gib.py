"""peak_mem_gib: torch.cuda.max_memory_allocated over set-up and window,
read before anything of the reference runs."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
