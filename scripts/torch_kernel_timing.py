#!/usr/bin/env python3
"""Time the port's flash-attention kernels in one checkout, for comparing
two commits on one card.

    python3 scripts/torch_kernel_timing.py [--tree PATH] [--only fwd|bwd]

PATH is the root of a checkout (default: the one this script is in); its
`transfusion_tpu_torch` is imported and its kernels are built there. Prints
one JSON line with the card's name and power limit and, per shape, the
mean ms of a run of launches (CUDA events, after warm-up launches) on
seeded bf16 inputs:

  forward (`flash_attention`): the serving path's text prefill (b8 h8
  n1024 d64, causal) and a short spanned sequence (b2 h8 n256 d64);
  backward, at the main-path shapes of the kernel table's rows:
    row 6: `flash_attention_nhd_backward`, b32 h8 n256 d64 token-major,
           RoPE, spans (40, 196) + (0, 0) (training run (a));
    row 8: `flash_attention_backward`, b8 h8 n1024 d64, 4 spans (run (b));
    row 9: `flash_attention_backward`, b1 h16 n16384 d64, 20 spans (the
           long-context run).
A backward call includes its delta = rowsum(dO o) and, where the checkout
has one, its dq scratch. Run the two trees in turns (parent, change,
change, parent) within one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FWD_SHAPES = (("text prefill b8 h8 n1024 d64 causal", 8, 1024, None),
              ("b2 h8 n256 d64 one span", 2, 256, (40, 196)))
# (name, b, h, n, spans, token-major, iterations)
BWD_SHAPES = (
    ("row 6 nhd b32 h8 n256 d64 rope spans2", 32, 8, 256, [(40, 196), (0, 0)], True, 50),
    ("row 8 b8 h8 n1024 d64 spans4", 8, 8, 1024, [(40 + 244 * i, 196) for i in range(4)],
     False, 50),
    ("row 9 b1 h16 n16384 d64 spans20", 1, 16, 16384, [(600 + 798 * i, 196) for i in range(20)],
     False, 10),
)


def mean_ms(torch, run, iters, warmup=3):
    for _ in range(warmup):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_forward(torch, out):
    from transfusion_tpu_torch.ops.flash_attn import flash_attention

    for name, b, n, span in FWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n)
        q, k, v = (torch.randn(b, 8, n, 64, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        spans = None if span is None else torch.tensor([[[0, *span]]] * b, device="cuda")
        out[name] = mean_ms(torch, lambda: flash_attention(q, k, v, spans=spans, causal=True),
                            50, warmup=5)


def time_backward(torch, out):
    from transfusion_tpu_torch.ops import flash_attn, flash_attn_nhd, rope
    from transfusion_tpu_torch.ops import spans as spans_mod

    d = 64
    for name, b, h, n, span_list, nhd, iters in BWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n + b)
        spans = torch.tensor([[[0, off, ln] for off, ln in span_list]] * b, dtype=torch.int32,
                             device="cuda")
        if nhd:
            q, k, v, do = (torch.randn(b, n, h * d, device="cuda", generator=g)
                           .to(torch.bfloat16) for _ in range(4))
            ang = rope.rope_angles(spans_mod.spans_to_rotary_positions(n, spans), d)
            cos, sin = torch.cos(ang), torch.sin(ang)
            o, lse = flash_attn_nhd._forward(q, k, v, h, cos, sin, spans, 50.0)

            def run():
                flash_attn_nhd.flash_attention_nhd_backward(q, k, v, o, lse, do, h, cos, sin,
                                                            spans, 50.0)
        else:
            q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=g)
                           .to(torch.bfloat16) for _ in range(4))
            o, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True,
                                                return_lse=True)

            def run():
                flash_attn.flash_attention_backward(q, k, v, o, lse, do, spans, 50.0)
        out[name] = mean_ms(torch, run, iters)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--only", choices=("fwd", "bwd"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"tree": os.path.abspath(args.tree), "card": card}
    if args.only != "bwd":
        time_forward(torch, out)
    if args.only != "fwd":
        time_backward(torch, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
