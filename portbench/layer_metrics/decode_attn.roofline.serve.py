"""The cached decode kernels' share of their roofline while serving
(source: device_trace).

Kernel time: the profiled ticks' kernels of `csrc/decode_attn.cu`
(`decode_mma`, `decode_warp`, `decode_fma`, `decode_merge`), which
`ops/decode_attn.py` (`decode_attention`) launches. Work, from the
requests' lengths: each decoded token's step reads the cache slots its row
holds (the architecture's `cache_slot_bytes`) and attends over them (its
`attention_pair` widths); bound by the bytes."""

from portbench import work

KERNELS = r"\bdecode_(mma|warp|fma|merge)\b"


def flops_and_bytes(arch, cfg, w) -> tuple[float, float]:
    return (work.attention_flops(arch.attention_pair(cfg), w["decode_kv"]),
            arch.cache_slot_bytes(cfg) * w["decode_kv"])


def read(ctx):
    w = work.serve_work(ctx["traced_ticks"])
    f, b = flops_and_bytes(ctx["arch"], ctx["cfg"], w)
    return work.roofline_share(ctx, f, b, work.kernel_seconds(ctx, KERNELS))
