"""The serving engine's mean share of its `max_batch` rows that were
active, over the decode steps of the window's ticks outside the profiled
ones, from the engine's tick rows (`active_slots` after the chunk, plus
the rows it `retired`, weighted by `chunk_k`) (source: program_counter)."""


def read(ctx):
    rows = [t["row"] for t in ctx["outside_ticks"] if t["row"] is not None]
    steps = sum(r["chunk_k"] for r in rows)
    if not steps:
        return None
    busy = sum((r["active_slots"] + r["retired"]) * r["chunk_k"] for r in rows)
    return 100.0 * busy / (steps * ctx["max_batch"])
