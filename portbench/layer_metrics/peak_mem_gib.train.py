"""The allocator's peak of device memory over the run up to the window's
close, `torch.cuda.max_memory_allocated()`, in GiB (source:
program_counter)."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx.get("peak_bytes") else None
