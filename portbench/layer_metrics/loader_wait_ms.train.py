"""Host milliseconds a step that the training loop waits in
`next(PackingLoader)`, by the harness's clock, over the window's steps
outside the profiled ones (source: host_clock)."""


def read(ctx):
    waits = ctx.get("loader_waits_s") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
