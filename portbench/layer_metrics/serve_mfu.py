"""The whole serving path's share of the card's bf16 peak: the model FLOPs
of the prefill and decode work of the window's ticks outside the profiled
ones, from the requests' lengths, over their host time x the peak
(source: host_clock).

A prompt of P tokens: every position through the blocks, causal attention
over its P (P + 1) / 2 pairs, the text head once (its last position). A
decoded token: one position through the blocks and the head, attention
over the slots it reads."""

from portbench import work


def flops(cfg, w) -> float:
    d, V = cfg["hidden_size"], cfg["num_text_tokens"] + 134
    inner, depth = cfg["num_attention_heads"] * cfg["head_dim"], cfg["num_hidden_layers"]
    per_pos = 2.0 * work.model_step_params(cfg)
    f = per_pos * w["prefill_tokens"] + 2.0 * V * d * w["prompts"]
    f += 4.0 * inner * depth * w["prefill_pairs"]
    f += (per_pos + 2.0 * V * d) * w["decoded"] + 4.0 * inner * depth * w["decode_kv"]
    return f


def read(ctx):
    if ctx["outside_s"] <= 0 or not ctx["outside_ticks"]:
        return None
    w = work.serve_work(ctx["outside_ticks"])
    return 100.0 * flops(ctx["cfg"], w) / (ctx["outside_s"] * ctx["peaks"]["bf16_flops_per_s"])
