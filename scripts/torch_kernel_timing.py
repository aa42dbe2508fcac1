#!/usr/bin/env python3
"""Time the port's forward attention kernel (kernel 1, `flash_attention`)
in one checkout, for comparing two commits on one card.

    python3 scripts/torch_kernel_timing.py [--tree PATH]

PATH is the root of a checkout (default: the one this script is in); its
`transfusion_tpu_torch` is imported and its kernels are built there. Prints
one JSON line with the card's name and power limit and, per shape, the
mean ms of 50 launches (CUDA events, after 5 warm-up launches) on seeded
bf16 inputs: the text prefill of the serving path (b8 h8 n1024 d64,
causal) and a short spanned sequence (b2 h8 n256 d64, one span). Run the
two trees in turns (parent, change, change, parent) within one call.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = (("text prefill b8 h8 n1024 d64 causal", 8, 1024, None),
          ("b2 h8 n256 d64 one span", 2, 256, (40, 196)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from transfusion_tpu_torch.ops.flash_attn import flash_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"tree": os.path.abspath(args.tree), "card": card}
    for name, b, n, span in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n)
        q, k, v = (torch.randn(b, 8, n, 64, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        spans = None if span is None else torch.tensor([[[0, *span]]] * b, device="cuda")
        run = lambda: flash_attention(q, k, v, spans=spans, causal=True)  # noqa: E731
        for _ in range(5):
            run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(50):
            run()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 50
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
