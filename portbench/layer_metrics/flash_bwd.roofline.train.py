"""The attention backward kernels' share of their roofline in the training
step (source: device_trace).

Kernel time: the profiled steps' kernels of `csrc/flash_bwd.cu`
(`flash_bwd_dkv_tc`, `flash_bwd_dq_store`, `flash_bwd_dkv`,
`flash_bwd_dq`, `row_ends`, `v_norm_max`, `cancel_bounds`), which the
backward of `ops/flash_attn.py` and `ops/flash_attn_nhd.py` launches.
Work, from the traffic: every layer's q k^T again, dO v^T, dV = P^T dO,
dQ = dS k and dK = dS^T q over the visible pairs (the architecture's
`attention_pair` widths); q, k, v, o, dO and the log-sum-exp read once, dq,
dk and dv written once (its `flash_position_bytes`; dO as o, dq dk dv as
q k v).
"""

from portbench import work

KERNELS = r"\b(flash_bwd_(dkv_tc|dq_store|dkv|dq)|row_ends|v_norm_max|cancel_bounds)\b"


def flops_and_bytes(arch, cfg, step_work) -> tuple[float, float]:
    flops = work.attention_backward_flops(arch.attention_pair(cfg), step_work["pairs"])
    b = arch.flash_position_bytes(cfg)
    nbytes = step_work["positions"] * (2 * (b["q"] + b["k"] + b["v"] + b["o"]) + b["lse"])
    return flops, nbytes


def read(ctx):
    seconds = work.kernel_seconds(ctx, KERNELS)
    fb = [flops_and_bytes(ctx["arch"], ctx["cfg"], w) for w in ctx["traced_work"]]
    return work.roofline_share(ctx, sum(f for f, _ in fb), sum(b for _, b in fb), seconds)
