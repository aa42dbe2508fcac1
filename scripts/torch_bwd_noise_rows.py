#!/usr/bin/env python3
"""The backward kernel on rows whose ds is float32 rounding noise, and the
time of its calls at the main paths' shapes.

    python3 scripts/torch_bwd_noise_rows.py [--root DIR] [--iters N]

Imports the port from DIR (default: this checkout) and `chip_smoke`'s
holds from this checkout, so that two checkouts' kernels can be set side by
side in one run on one card (run it once with each checkout's --root). Builds
the port's kernels, prints the card's name and power limit, then one JSON
line per case:

- "noise rows": phase 2's case of a row that sees one key and whose
  dO . v cancels (`chip_smoke.bwd_case(cancel_row0=True)`, b8 h8 n256 d64,
  bf16 and float32): the hold's errors and whether it meets the row rule
  (0.08 bf16, 1e-3 float32);
- "ms": the mean ms of N (default 20) calls of the head-major backward
  at the long-context main path's shape (1 x 16 x 16384 x 64 bf16, 20 image
  spans of 196 at phase 6's packing offsets) and of the token-major
  backward at the bench's (b32 h8 n256 d64 bf16, RoPE, a span at 40 of
  196), on seeded random inputs;
- "kernels": at the token-major shape, the device µs a call of each
  kernel that the backward launches (`torch.profiler`, 20 calls).

Needs one card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from transfusion_tpu_torch.ops import _build, flash_attn, flash_attn_nhd, rope, spans

    if not torch.cuda.is_available():
        print("torch_bwd_noise_rows: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    mods = dict(flash=flash_attn, nhd=flash_attn_nhd, rope=rope, spans=spans)
    ok = True
    for dtype, tol in ((torch.bfloat16, 0.08), (torch.float32, 1e-3)):
        sp = torch.tensor([[[0, 33, 196]]] * 8, dtype=torch.int32, device="cuda")
        res = cs.bwd_case(torch, mods, 8, 8, 256, 64, dtype, sp, iters=3, cancel_row0=True)
        passed = res["row_rel_err"] <= tol
        ok &= passed
        print(json.dumps({"root": root, "case": "noise rows", "dtype": str(dtype),
                          "err": res["err"], "rel_err": res["rel_err"],
                          "row_rel_err": res["row_rel_err"], "row_rule": tol,
                          "passes": passed}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    groups = [[0, 601 + 798 * i, 196] for i in range(20)]
    sp = torch.tensor([groups], dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn(1, 16, 16384, 64, device="cuda", generator=g).to(bf16)
                   for _ in range(4))
    out, lse = flash_attn.flash_attention(q, k, v, spans=sp, softcap=50.0, return_lse=True)
    long_ms = cs.time_ms(lambda: flash_attn.flash_attention_backward(
        q, k, v, out, lse, do, sp, 50.0), args.iters)
    del q, k, v, do, out, lse

    b, h, n, d = 32, 8, 256, 64
    sp = torch.tensor([[[0, 40, 196], [0, 0, 0]]] * b, dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn(b, n, h * d, device="cuda", generator=g).to(bf16)
                   for _ in range(4))
    ang = rope.rope_angles(spans.spans_to_rotary_positions(n, sp), d)
    cos, sin = torch.cos(ang), torch.sin(ang)
    out, lse = flash_attn_nhd._forward(q, k, v, h, cos, sin, sp, 50.0)
    nhd_ms = cs.time_ms(lambda: flash_attn_nhd.flash_attention_nhd_backward(
        q, k, v, out, lse, do, h, cos, sin, sp, 50.0), args.iters)
    print(json.dumps({"root": root, "case": "ms",
                      "head-major b1 h16 n16384 d64 bf16 spans20": long_ms,
                      "token-major b32 h8 n256 d64 bf16 rope spans2": nhd_ms}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flash_attn_nhd.flash_attention_nhd_backward(q, k, v, out, lse, do, h, cos, sin, sp,
                                                        50.0)
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        for name in ("row_ends", "v_norm_max", "cancel_bounds", "flash_bwd_dkv_tc",
                     "flash_bwd_dq_store"):
            if f"::{name}" in e.key:
                total = getattr(e, "device_time_total", None)
                us[name] = (e.cuda_time_total if total is None else total) / 20
    print(json.dumps({"root": root, "case": "kernels",
                      "token-major b32 h8 n256 d64 bf16 rope spans2, device us a call": us}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
