"""Milliseconds a decode step: the engine's `chunk_seconds` (a host clock
around a chunk that ends in its one fetch) over its `chunk_k`, summed over
the window's ticks outside the profiled ones (source: program_span)."""


def read(ctx):
    rows = [t["row"] for t in ctx["outside_ticks"] if t["row"] is not None]
    steps = sum(r["chunk_k"] for r in rows)
    return 1e3 * sum(r["chunk_seconds"] for r in rows) / steps if steps else None
