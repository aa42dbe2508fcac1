"""The 90th percentile of time to first token, in ms, from each request's
due time to the host holding its first token, over the requests due in
the traced run's window that neither waited nor decoded while the
profiler ran (source: host_clock).

A per-layer reading and no end-to-end metric: the engine's chunk lengths
come from a cost model that `warmup()` fits once, and the fit is kept or
rejected by noise, so this tail moves by a factor of two from run to run
(§6 of PERF.md)."""

from portbench.common import percentile


def read(ctx):
    waits = ctx.get("ttft_ms_outside") or []
    return percentile(waits, 90) if waits else None
