"""Host milliseconds a decode step before the chunk's fetch (its draws and
launches): the engine's `dispatch_seconds` over its `chunk_k`, summed over
the window's ticks outside the profiled ones (source: program_span)."""

from portbench.spans import per_decode_step_ms


def read(ctx):
    return per_decode_step_ms(ctx, "dispatch_seconds")
