"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window
(reset at its start, so the state held through it counts), in GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2**30 if ctx.window_peak_bytes else None
