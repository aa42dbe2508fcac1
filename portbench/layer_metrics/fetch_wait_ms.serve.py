"""Host milliseconds a decode step blocked in the chunk's fetch, waiting
for the card: the engine's `fetch_seconds` over its `chunk_k`, summed over
the window's ticks outside the profiled ones (source: program_span)."""

from portbench.spans import per_decode_step_ms


def read(ctx):
    return per_decode_step_ms(ctx, "fetch_seconds")
