"""Milliseconds a traced step in which the card ran nothing while the host
waited for the packing loader's next batch (the span
`transfusion.loader.next`), over the profiled steps (source:
device_trace)."""

from portbench.spans import idle_inside


def read(ctx):
    idle = idle_inside(ctx, "transfusion.loader.next")
    return None if idle is None else 1e3 * idle / len(ctx["traced_work"])
