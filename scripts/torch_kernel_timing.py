#!/usr/bin/env python3
"""Time the port's attention kernels in one checkout, for comparing two
commits on one card.

    python3 scripts/torch_kernel_timing.py [--tree PATH] [--only fwd|bwd|decode]
    python3 scripts/torch_kernel_timing.py --compare PARENT [--only fwd|bwd|decode]

PATH is the root of a checkout (default: the one this script is in); its
`transfusion_tpu_torch` is imported and its kernels are built there. Prints
one JSON line with the card's name and power limit, the registers and
spills `ptxas -v` reported for the tree's forward kernels, and, per shape,
the mean ms of a run of launches (CUDA events, after warm-up launches) on
seeded bf16 inputs, at the main-path shapes of the kernel table's rows:

  forward:
    row 1: `flash_attention`, b2 h8 n64 d64, 2 spans (the `sample`
           prefill's batched envelope);
    row 2: `flash_attention`, b8 h8 n1024 d64, causal (the serving text
           prefill);
    row 3: `flash_attention`, b1 h16 n16384 d64, 20 spans (the long-context
           run);
    row 5: `flash_attention_nhd`, b32 h8 n256 d64 token-major, RoPE, spans
           (40, 196) + (0, 0) (training run (a));
  backward:
    row 6: `flash_attention_nhd_backward` at row 5's shape;
    row 7: `flash_attention_backward`, b2 h8 n256 d32, 1 span (its envelope;
           no main path reaches it);
    row 8: `flash_attention_backward`, b8 h8 n1024 d64, 4 spans (run (b));
    row 9: `flash_attention_backward` at row 3's shape;
  cached decode (row 4, `decode_attention`, d 64, bf16 q; lens from the
  serving runs, valid slots a prefix):
    text: b8 h8 nq1 cap1152, the bench model's ragged prompts + 64 tokens;
    ODE: b2 h8 nq196 cap512 (CFG rows), lens 222;
    long: b8 h8 nq1 cap8192, lens 8192 - 37 i, bf16 and int8 caches (the
          cache, 134 MB in bf16, does not fit in L2; the shorter ones do).
  q k 192 beside v 128 (`--only pair`, the moonlight cell's latent
  attention; checkouts before the pair do not take it): forward and
  backward at b8 h16 n4096 with the 4k cell's caption-image spans, and at
  b1 h16 n8192 (its context), no softcap; each with its bound (the larger
  of its FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s).
A backward call includes its delta = rowsum(dO o) and, where the checkout
has one, its dq scratch. --compare PARENT runs this script on PARENT (a
checkout unpacked with `git archive`) and on this checkout in turns
(parent, change, change, parent), each in its own process, and then prints
one JSON line per shape with the four times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, b, h, n, spans, token-major, iterations)
FWD_SHAPES = (
    ("row 1 b2 h8 n64 d64 spans2", 2, 8, 64, [(10, 30), (45, 12)], False, 200),
    ("row 2 b8 h8 n1024 d64 causal", 8, 8, 1024, None, False, 100),
    ("row 3 b1 h16 n16384 d64 spans20", 1, 16, 16384, [(600 + 798 * i, 196) for i in range(20)],
     False, 10),
    ("row 5 nhd b32 h8 n256 d64 rope spans2", 32, 8, 256, [(40, 196), (0, 0)], True, 100),
)
# (name, b, h, n, d, spans, token-major, iterations)
BWD_SHAPES = (
    ("row 6 nhd b32 h8 n256 d64 rope spans2", 32, 8, 256, 64, [(40, 196), (0, 0)], True, 50),
    ("row 7 b2 h8 n256 d32 spans1", 2, 8, 256, 32, [(40, 196)], False, 100),
    ("row 8 b8 h8 n1024 d64 spans4", 8, 8, 1024, 64, [(40 + 244 * i, 196) for i in range(4)],
     False, 50),
    ("row 9 b1 h16 n16384 d64 spans20", 1, 16, 16384, 64,
     [(600 + 798 * i, 196) for i in range(20)], False, 10),
)


# (name, b, h, nq, cap, lens, int8, iterations)
DECODE_SHAPES = (
    ("row 4 text b8 h8 nq1 cap1152 d64 bf16", 8, 8, 1, 1152,
     [n + 64 for n in (37, 160, 283, 406, 530, 653, 776, 900)], False, 200),
    ("row 4 ODE b2 h8 nq196 cap512 d64 bf16", 2, 8, 196, 512, [222, 222], False, 200),
    ("row 4 long b8 h8 nq1 cap8192 d64 bf16", 8, 8, 1, 8192, [8192 - 37 * i for i in range(8)],
     False, 100),
    ("row 4 long b8 h8 nq1 cap8192 d64 int8", 8, 8, 1, 8192, [8192 - 37 * i for i in range(8)],
     True, 100),
)


# (name, b, h, n, spans, iterations): q k 192, v 128, no softcap
PAIR_SHAPES = (
    ("pair b8 h16 n4096 qk192 v128 spans5", 8, 16, 4096, [(40 + 800 * i, 256) for i in range(5)],
     20),
    ("pair b1 h16 n8192 qk192 v128 causal", 1, 16, 8192, None, 10),
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


def inputs(torch, b, h, n, span_list, nhd, count, d=64):
    """Seeded bf16 tensors ([b, n, h*d] or [b, h, n, d]), spans and, for
    the token-major route, RoPE angles."""
    from transfusion_tpu_torch.ops import rope
    from transfusion_tpu_torch.ops import spans as spans_mod

    g = torch.Generator(device="cuda").manual_seed(n + b)
    shape = (b, n, h * d) if nhd else (b, h, n, d)
    ts = [torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(count)]
    spans = None if span_list is None else torch.tensor(
        [[[0, off, ln] for off, ln in span_list]] * b, dtype=torch.int32, device="cuda")
    cos = sin = None
    if nhd:
        ang = rope.rope_angles(spans_mod.spans_to_rotary_positions(n, spans), d)
        cos, sin = torch.cos(ang), torch.sin(ang)
    return ts, spans, cos, sin


def time_forward(torch, out):
    from transfusion_tpu_torch.ops import flash_attn, flash_attn_nhd

    for name, b, h, n, span_list, nhd, iters in FWD_SHAPES:
        (q, k, v), spans, cos, sin = inputs(torch, b, h, n, span_list, nhd, 3)
        if nhd:
            def run():
                flash_attn_nhd.flash_attention_nhd(q, k, v, h, cos=cos, sin=sin, spans=spans,
                                                   causal=True)
        else:
            def run():
                flash_attn.flash_attention(q, k, v, spans=spans, causal=True)
        out[name] = mean_ms(torch, run, iters, warmup=5)
        del q, k, v
        torch.cuda.empty_cache()


def ptxas_report():
    """[kernel, registers, spill stores, spill loads] of the tree's
    csrc/flash_fwd.cu build, from its `ptxas -v` log."""
    from transfusion_tpu_torch.ops import _build

    rows, name, spills = [], None, (None, None)
    for line in _build.ptxas_log("flash_fwd").splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spills = m.group(1), (None, None)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append([name, int(m.group(1)), *spills])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, nm in zip(rows, names):
            r[0] = nm.replace("(anonymous namespace)::", "").removeprefix("void ")
    return rows


def time_backward(torch, out):
    from transfusion_tpu_torch.ops import flash_attn, flash_attn_nhd

    for name, b, h, n, d, span_list, nhd, iters in BWD_SHAPES:
        (q, k, v, do), spans, cos, sin = inputs(torch, b, h, n, span_list, nhd, 4, d)
        if nhd:
            o, lse = flash_attn_nhd._forward(q, k, v, h, cos, sin, spans, 50.0)

            def run():
                flash_attn_nhd.flash_attention_nhd_backward(q, k, v, o, lse, do, h, cos, sin,
                                                            spans, 50.0)
        else:
            o, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True,
                                                return_lse=True)

            def run():
                flash_attn.flash_attention_backward(q, k, v, o, lse, do, spans, 50.0)
        out[name] = mean_ms(torch, run, iters)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def time_decode(torch, out):
    from transfusion_tpu_torch.models.layers import _quantize_rows
    from transfusion_tpu_torch.ops import decode_attn

    for name, b, h, nq, cap, lens, int8, iters in DECODE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(cap + nq)
        q, k, v = (torch.randn(b, h, n, 64, device="cuda", generator=g).to(torch.bfloat16)
                   for n in (nq, cap, cap))
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bias = torch.where(torch.arange(cap, device="cuda")[None, :] < lens_t[:, None], 0.0,
                           -1e30).float().contiguous()
        ks = vs = None
        if int8:
            k, ks = _quantize_rows(k)
            v, vs = _quantize_rows(v)
            ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        out[name] = mean_ms(torch, lambda: decode_attn.decode_attention(
            q, k, v, bias, ks, vs, 50.0, lens_t), iters, warmup=5)
        del q, k, v
        torch.cuda.empty_cache()


def time_pair(torch, out):
    """Forward and backward at (192, 128), and each one's bound."""
    from transfusion_tpu_torch.ops import flash_attn

    for name, b, h, n, span_list, iters in PAIR_SHAPES:
        (q, k), spans, _, _ = inputs(torch, b, h, n, span_list, False, 2, 192)
        (v, do), _, _, _ = inputs(torch, b, h, n, span_list, False, 2, 128)
        o, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True, softcap=0.0,
                                            return_lse=True)
        pairs = b * (n * (n + 1) // 2 + sum(ln * (ln - 1) // 2 for _, ln in span_list or ()))
        pos_bytes = b * n * h * (2 * (192 + 192 + 128 + 128) + 4)
        fwd_bound = max(2.0 * h * (192 + 128) * pairs / 989e12, pos_bytes / 3.35e12) * 1e3
        bwd_bound = max(2.0 * h * (3 * 192 + 2 * 128) * pairs / 989e12,
                        (2 * pos_bytes - b * n * h * 4) / 3.35e12) * 1e3
        out[name + " fwd"] = [mean_ms(torch, lambda: flash_attn.flash_attention(
            q, k, v, spans=spans, causal=True, softcap=0.0), iters), fwd_bound]
        out[name + " bwd"] = [mean_ms(torch, lambda: flash_attn.flash_attention_backward(
            q, k, v, o, lse, do, spans, 0.0), iters), bwd_bound]
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def compare(parent, only):
    """Run the parent and this checkout in turns; one JSON line per shape."""
    runs = []
    for tree in (parent, HERE, HERE, parent):
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree]
        if only:
            cmd += ["--only", only]
        res = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for name in (s[0] for s in FWD_SHAPES + BWD_SHAPES + DECODE_SHAPES):
        if name in runs[0]:
            print(json.dumps({"shape": name, "parent_ms": [runs[0][name], runs[3][name]],
                              "change_ms": [runs[1][name], runs[2][name]],
                              "card": runs[1]["card"]}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--compare", metavar="PARENT")
    ap.add_argument("--only", choices=("fwd", "bwd", "decode", "pair"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.compare:
        return compare(os.path.abspath(args.compare), args.only)
    sys.path.insert(0, os.path.abspath(args.tree))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"tree": os.path.abspath(args.tree), "card": card}
    if args.only in (None, "fwd"):
        time_forward(torch, out)
        out["ptxas flash_fwd [kernel, registers, spill stores, spill loads]"] = ptxas_report()
    if args.only in (None, "bwd"):
        time_backward(torch, out)
    if args.only in (None, "decode"):
        time_decode(torch, out)
    if args.only == "pair":
        time_pair(torch, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
