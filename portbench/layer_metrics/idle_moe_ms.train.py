"""Milliseconds a traced step in which the card ran nothing while the host
was inside an expert layer's spans (`transfusion.moe.route`, `.experts`,
`.combine`, `.shared`, `models/moonlight.py`; the forward's and the
recompute's), over the profiled steps (source: device_trace)."""

from portbench.spans import idle_inside

SPANS = ("transfusion.moe.route", "transfusion.moe.experts", "transfusion.moe.combine",
         "transfusion.moe.shared")


def read(ctx):
    idle = [x for x in (idle_inside(ctx, name) for name in SPANS) if x is not None]
    return 1e3 * sum(idle) / len(ctx["traced_work"]) if idle else None
