"""The whole serving path's share of the card's bf16 peak: the model FLOPs
of the prefill and decode work of the window's ticks outside the profiled
ones, from the requests' lengths (the architecture's `serve_flops`: a
prompt's positions through the blocks, its causal pairs and the text head
once; a decoded token's position, the head and the slots it reads), over
their host time x the peak (source: host_clock)."""

from portbench import work


def read(ctx):
    if ctx["outside_s"] <= 0 or not ctx["outside_ticks"]:
        return None
    w = work.serve_work(ctx["outside_ticks"])
    f = ctx["arch"].serve_flops(ctx["cfg"], w)
    return 100.0 * f / (ctx["outside_s"] * ctx["peaks"]["bf16_flops_per_s"])
