"""What the readers of the program's own spans and tick-row fields share.

The program names its layer boundaries with host ranges
(`transfusion.<layer>.<what>`, `transfusion_tpu_torch/training/metrics.py`)
in the same trace as the card's kernels, on the same clock base. A traced
run's idle time is given to a layer where the card ran nothing while the
host was inside that layer's span. A program without the spans, or a tick
row without the fields, gives nothing, and the reader reports nothing."""

from __future__ import annotations


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (name, start, end) intervals inside [lo, hi), as sorted
    disjoint [start, end) pairs."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(ctx: dict, name: str):
    """Seconds of the traced window [trace_lo, trace_hi] in which the card
    ran nothing while the host was inside a span named `name`; None when
    the trace holds no such span."""
    spans = [op for op in ctx["host_ops"] if op[0] == name]
    if not spans:
        return None
    lo, hi = ctx["trace_lo"], ctx["trace_hi"]
    inside = merged(spans, lo, hi)
    return sum(e - s for s, e in inside) - overlap(inside, merged(ctx["device_ops"], lo, hi))


def tick_rows(ticks: list, key: str) -> list:
    """The tick rows of `ticks` that hold `key`."""
    return [t["row"] for t in ticks if t["row"] is not None and key in t["row"]]


def per_admitted_ms(ctx: dict, key: str):
    """1000 x the sum of `key` over the sum of `admitted`, over the
    window's ticks outside the profiled ones; None when nothing was
    admitted or the rows lack `key`."""
    rows = tick_rows(ctx["outside_ticks"], key)
    admitted = sum(r["admitted"] for r in rows)
    return 1e3 * sum(r[key] for r in rows) / admitted if admitted else None


def per_decode_step_ms(ctx: dict, key: str):
    """1000 x the sum of `key` over the sum of `chunk_k`, over the window's
    ticks outside the profiled ones; None when no step ran or the rows
    lack `key`."""
    rows = tick_rows(ctx["outside_ticks"], key)
    steps = sum(r["chunk_k"] for r in rows)
    return 1e3 * sum(r[key] for r in rows) / steps if steps else None
