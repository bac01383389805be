"""Device: the peak of ``torch.cuda.max_memory_allocated`` over the run
to the window's end, on the fullest card, in GiB."""


def read(ctx):
    return ctx["memory_peak"] / 2**30 if ctx.get("memory_peak") else None
