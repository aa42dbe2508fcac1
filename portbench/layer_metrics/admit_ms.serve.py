"""Host milliseconds of admission and prefill a request admitted: over the
window's ticks outside the profiled ones, (the ticks' wall time by the
harness's clock - the engine's `chunk_seconds`) / the requests admitted
(source: program_span)."""


def read(ctx):
    ticks = ctx["outside_ticks"]
    admitted = sum(len(t["work"]["admitted"]) for t in ticks)
    if not admitted:
        return None
    wall = sum(t["t1"] - t["t0"] for t in ticks)
    chunks = sum(t["row"]["chunk_seconds"] for t in ticks if t["row"] is not None)
    return 1e3 * (wall - chunks) / admitted
