"""The attention forward kernels' share of their roofline in the serving
engine's prefill (source: device_trace).

Kernel time: the profiled ticks' kernels of `csrc/flash_fwd.cu`
(`flash_fwd_tc`, `flash_fwd_kernel`), launched by `ops/flash_attn.py`
(`flash_attention`) over each admitted group's prompts. Work, from the
requests' lengths (not the padded width): causal q k^T and p v over each
prompt's P (P + 1) / 2 pairs in every layer, and q, k, v and o of its P
positions once in bf16."""

from portbench import work

KERNELS = r"\bflash_fwd_(tc|kernel)\b"


def flops_and_bytes(cfg, w) -> tuple[float, float]:
    inner, depth = cfg["num_attention_heads"] * cfg["head_dim"], cfg["num_hidden_layers"]
    return (4.0 * inner * depth * w["prefill_pairs"],
            depth * w["prefill_tokens"] * 4 * inner * 2.0)


def read(ctx):
    w = work.serve_work(ctx["traced_ticks"])
    f, b = flops_and_bytes(ctx["cfg"], w)
    return work.roofline_share(ctx, f, b, work.kernel_seconds(ctx, KERNELS))
