"""Host milliseconds of admission and prefill a request admitted, by the
engine's own clock: its `admit_seconds` over its `admitted`, summed over
the window's ticks outside the profiled ones (source: program_span)."""

from portbench.spans import per_admitted_ms


def read(ctx):
    return per_admitted_ms(ctx, "admit_seconds")
