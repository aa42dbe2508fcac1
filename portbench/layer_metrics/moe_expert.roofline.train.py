"""The held routed experts' grouped products' share of their roofline in
the training step (source: device_trace).

Kernel time: the profiled steps' grouped GEMM kernels, which
`torch._grouped_mm` launches for `models/moonlight.py`'s `Experts.grouped`
(forward, its recompute under remat, and the backward's products for the
rows' and the weights' gradients). Work, from the program's device counter
of (token, held expert) assignments over the profiled steps (`MoE.
expert_load`, snapshotted around them by `runners/train_experts.py`): each
assignment's gate, up and down products, twice the forward's under remat
plus the backward's two; bytes, the held experts' weights and the permuted
rows in and out each time (the architecture's `expert_flops_and_bytes`).
"""

from portbench import work

KERNELS = r"GroupProblemShape|grouped_mm|GroupedGemm|grouped_gemm"


def read(ctx):
    counts = ctx.get("moe_traced_counts")
    if not counts:
        return None
    passes = 4 if ctx.get("remat") else 3
    flops, nbytes = ctx["arch"].expert_flops_and_bytes(ctx["cfg"], sum(map(sum, counts)), passes)
    return work.roofline_share(ctx, flops, nbytes, work.kernel_seconds(ctx, KERNELS))
