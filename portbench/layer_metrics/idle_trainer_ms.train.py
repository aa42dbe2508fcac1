"""Milliseconds a traced step in which the card ran nothing while the host
was inside the trainer's step (the span `transfusion.train.step`), over
the profiled steps (source: device_trace)."""

from portbench.spans import idle_inside


def read(ctx):
    idle = idle_inside(ctx, "transfusion.train.step")
    return None if idle is None else 1e3 * idle / len(ctx["traced_work"])
