"""The attention forward kernels' share of their roofline in the serving
engine's prefill (source: device_trace).

Kernel time: the profiled ticks' kernels of `csrc/flash_fwd.cu`
(`flash_fwd_tc`, `flash_fwd_kernel`), launched by `ops/flash_attn.py`
(`flash_attention`) over each admitted group's prompts. Work, from the
requests' lengths (not the padded width): causal q k^T and p v over each
prompt's P (P + 1) / 2 pairs in every layer (the architecture's
`attention_pair` widths), and q, k, v and o of its P positions once (its
`flash_position_bytes`)."""

from portbench import work

KERNELS = r"\bflash_fwd_(tc|kernel)\b"


def flops_and_bytes(arch, cfg, w) -> tuple[float, float]:
    b = arch.flash_position_bytes(cfg)
    return (work.attention_flops(arch.attention_pair(cfg), w["prefill_pairs"]),
            w["prefill_tokens"] * (b["q"] + b["k"] + b["v"] + b["o"]))


def read(ctx):
    w = work.serve_work(ctx["traced_ticks"])
    f, b = flops_and_bytes(ctx["arch"], ctx["cfg"], w)
    return work.roofline_share(ctx, f, b, work.kernel_seconds(ctx, KERNELS))
