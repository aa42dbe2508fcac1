"""The share of decode steps the serving engine replayed from a captured
CUDA graph: 100 x the sum of the engine's `graph_steps` over the sum of its
`chunk_k`, over the window's ticks outside the profiled ones (source:
program_counter). None when no step ran, or on a program whose tick rows
lack the field."""

from portbench.spans import tick_rows


def read(ctx):
    rows = tick_rows(ctx["outside_ticks"], "graph_steps")
    steps = sum(r["chunk_k"] for r in rows)
    return 100.0 * sum(r["graph_steps"] for r in rows) / steps if steps else None
