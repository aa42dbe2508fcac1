"""Milliseconds a traced decode step in which the card ran nothing while
the host was launching a decode chunk (the span
`transfusion.engine.decode`), over the `chunk_k` of the profiled ticks
(source: device_trace)."""

from portbench.spans import idle_inside, tick_rows


def read(ctx):
    idle = idle_inside(ctx, "transfusion.engine.decode")
    steps = sum(r["chunk_k"] for r in tick_rows(ctx["traced_ticks"], "chunk_k"))
    return 1e3 * idle / steps if idle is not None and steps else None
