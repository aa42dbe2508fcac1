"""The whole training step's share of the card's bf16 peak: the model
FLOPs of the steps' tokens (3 x the forward's, which the architecture
counts: every position through the blocks, the text head on text
positions, attention over the visible pairs; recomputation not counted)
over the steps' host time x the peak, over the window's steps outside the
profiled ones (source: host_clock)."""


def flops(arch, cfg, step_work) -> float:
    """A training step's model FLOPs: forward and backward, 3 x forward."""
    return 3.0 * arch.forward_flops(cfg, step_work)


def read(ctx):
    steps = ctx.get("outside_work") or []
    if not steps or ctx["outside_s"] <= 0:
        return None
    total = sum(flops(ctx["arch"], ctx["cfg"], w) for w in steps)
    return 100.0 * total / (ctx["outside_s"] * ctx["peaks"]["bf16_flops_per_s"])
