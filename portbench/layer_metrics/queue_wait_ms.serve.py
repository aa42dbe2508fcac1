"""Mean milliseconds from a request's submit to its admission: the
engine's `queued_seconds` over its `admitted`, summed over the window's
ticks outside the profiled ones (source: program_span)."""

from portbench.spans import per_admitted_ms


def read(ctx):
    return per_admitted_ms(ctx, "queued_seconds")
