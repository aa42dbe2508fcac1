"""How unevenly the router loads the held experts: each expert layer's
busiest held expert's (token, expert) assignments over the mean of its
held experts', averaged over the layers, over the window's steps, from the
program's device counters (`MoE.expert_load`, read after the window by
`runners/train_experts.py`) (source: program_counter)."""


def read(ctx):
    counts = [c for c in ctx.get("moe_window_counts") or [] if sum(c)]
    if not counts:
        return None
    return sum(max(c) * len(c) / sum(c) for c in counts) / len(counts)
