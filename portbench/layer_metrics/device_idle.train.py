"""The share of the profiled steps' wall time in which the card ran
nothing: 1 - the union of the kernels', copies' and sets' intervals over
the traced window (source: device_trace)."""


def read(ctx):
    if ctx["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
