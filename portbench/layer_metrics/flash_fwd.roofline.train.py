"""The attention forward kernels' share of their roofline in the training
step (source: device_trace).

Kernel time: the profiled steps' kernels of `csrc/flash_fwd.cu`
(`flash_fwd_tc`, `flash_fwd_kernel`), which the entry points
`ops/flash_attn.py` (`flash_attention`) and `ops/flash_attn_nhd.py`
(`flash_attention_nhd`) launch. Work, from the traffic: every layer's
q k^T and p v over the rows' visible pairs (the architecture's
`attention_pair` widths), and q, k, v and o read or written once and the
float32 log-sum-exp (its `flash_position_bytes`); twice under remat, whose
backward runs the forward again.
"""

from portbench import work

KERNELS = r"\bflash_fwd_(tc|kernel)\b"


def flops_and_bytes(arch, cfg, step_work, calls: int) -> tuple[float, float]:
    flops = work.attention_flops(arch.attention_pair(cfg), step_work["pairs"])
    nbytes = step_work["positions"] * sum(arch.flash_position_bytes(cfg).values())
    return calls * flops, calls * nbytes


def read(ctx):
    seconds = work.kernel_seconds(ctx, KERNELS)
    calls = 2 if ctx.get("remat") else 1
    fb = [flops_and_bytes(ctx["arch"], ctx["cfg"], w, calls) for w in ctx["traced_work"]]
    return work.roofline_share(ctx, sum(f for f, _ in fb), sum(b for _, b in fb), seconds)
