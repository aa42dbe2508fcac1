"""The cached decode kernels' share of their roofline while serving
(source: device_trace).

Kernel time: the profiled ticks' kernels of `csrc/decode_attn.cu`
(`decode_mma`, `decode_warp`, `decode_fma`, `decode_merge`), which
`ops/decode_attn.py` (`decode_attention`) launches. Work, from the
requests' lengths: each decoded token's step reads the K and V of the
slots its row holds, in bf16, in every layer (4 x heads x head_dim FLOPs a
slot); bound by the bytes."""

from portbench import work

KERNELS = r"\bdecode_(mma|warp|fma|merge)\b"


def flops_and_bytes(cfg, w) -> tuple[float, float]:
    inner, depth = cfg["num_attention_heads"] * cfg["head_dim"], cfg["num_hidden_layers"]
    return 4.0 * inner * depth * w["decode_kv"], 2.0 * 2 * inner * depth * w["decode_kv"]


def read(ctx):
    w = work.serve_work(ctx["traced_ticks"])
    f, b = flops_and_bytes(ctx["cfg"], w)
    return work.roofline_share(ctx, f, b, work.kernel_seconds(ctx, KERNELS))
