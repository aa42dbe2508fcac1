#!/usr/bin/env python3
"""Drive the PyTorch port (`transfusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build: compile every CUDA kernel of the port from
     `transfusion_tpu_torch/csrc/` (one nvcc per source, in parallel);
     print the card's name and power limit;
  2. kernels vs plain: each kernel against its plain PyTorch version on the
     same inputs, at synthetic shapes around the main paths' (forwards:
     bf16 within 2e-2, float32 within 1e-4 max abs error; every row's max
     error also within 0.08 (bf16) / 1e-3 (float32) of that row's RMS;
     backwards: dq/dk/dv within 1e-2 (bf16) / 1e-4 (float32) of the
     gradient's largest element, rows as the forwards), with kernel ms,
     plain ms and the card's bound;
  3. reference: a small float32 model on the card (kernels) against the
     same weights on the CPU (plain versions): prefill logits, greedy
     tokens and sampled latents must agree, and one training step's loss
     and every gradient (head-major and token-major attention) within 1e-4;
  4. serving: the bench model at full width (dim 384, depth 8, 8x64 heads,
     bf16, seeded weights) through `generate_text_batch` (8 ragged prompts,
     128 new tokens, greedy; bf16 and int8 KV) and `sample(cache_kv=True)`
     with CFG. Each path's warm-up captures the tensors of one prefill and
     one decode call, and each kernel is held against its plain version on
     them (as in phase 2). Then the path runs with the launch counters set
     to 0 and must launch both kernels;
  5. training: the same bench model through `Trainer.train_step`: (a)
     `bench.py`'s batch, 32 x [32 text][14x14x32 latent][8 text], n 256
     after the shift (every layer takes the token-major route), and (b) 8
     samples of four such groups, n 1024 (the head-major route). A warm-up
     step captures one attention call (forward inputs and the output's
     cotangent) and holds the forward and backward kernels against their
     plain versions on them; then 20 steps with the counters set to 0 must
     launch the route's forward and backward kernels once per layer per
     step, and the loss must be finite and fall (the 20 steps reuse one
     set of draws, so the loss compares like with like);
  6. long-context training: the 573M config of `scripts/probe_573m.py`
     (dim 1024, depth 12, 16x64 heads, vocab 50k, per-block remat 'full',
     ce_chunk_size 256, bf16; seeded weights) at full width through
     `Trainer(grad_accumulation=2).train_step` on 2 samples of 20 x
     ([600 text][14x14x32 latent]) + text, each packed to n 16384 after the
     shift: every layer takes the TPU's streamed envelope (rows 3 and 9 of
     the kernel table). The warm-up step captures one attention call, held
     against the plain versions computed 1024 query rows at a time; then
     LONG_STEPS steps with the counters set to 0 must launch the streamed
     forward 2 x 12 x 2 times a step (remat runs it again in the backward)
     and the backward 12 x 2 times, the loss must be finite and fall, and
     one step with remat_policy 'dots' from the same state and draws must
     give the same loss within 1e-3 relative;
  7. the `kernels` line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`library_ms` in the kernels line is `torch.compile`d `flex_attention` with a
tanh `score_mod` and the span block mask on the same tensors (for the
token-major route: on the rotated, head-major q/k, so without the RoPE and
layout work the kernels also do); it is a yardstick, and the port never
calls it.

Without a CUDA device, or outside a checkout of the repository, it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

BENCH_CFG = dict(
    num_text_tokens=256, dim_latent=32, modality_default_shape=(14, 14),
    transformer=dict(dim=384, depth=8, dim_head=64, heads=8, attn_impl="flash"),
)
SMALL_CFG = dict(
    num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4), pad_multiple=16,
    transformer=dict(dim=64, depth=2, dim_head=32, heads=2, attn_impl="flash"),
)
SMALL_NHD_CFG = dict(SMALL_CFG, transformer=dict(dim=128, depth=2, dim_head=64, heads=2,
                                                  attn_impl="flash"))
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# max row error over the reference row's RMS: output rounding alone gives up
# to one bf16 ulp (2^-7 relative) of the row's largest element, ~3x its RMS
ROW_REL_TOL = {"bfloat16": 0.08, "float32": 1e-3}
# dq/dk/dv: max abs error over the gradient's largest element. Both sides
# sum in float32 from the same inputs; in bf16 each output element is then
# rounded (2^-8 relative), so 1e-2 is 2.5 ulps of the largest element; in
# float32 the two summation orders agree to ~1e-6
BWD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
TRAIN_STEPS = 20
# scripts/probe_573m.py:29-41, unchanged
LONG_CFG = dict(
    num_text_tokens=50_000, dim_latent=32, modality_default_shape=(14, 14), pad_multiple=64,
    ce_chunk_size=256,
    transformer=dict(dim=1024, depth=12, dim_head=64, heads=16, attn_impl="flash",
                     remat=True, remat_policy="full"),
)
LONG_GROUPS, LONG_TAIL, LONG_N = 20, 270, 16385  # packed length before the shift
LONG_STEPS = 4
LONG_BLOCK_Q = 1024  # query rows per block of the plain versions at n 16384


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=10):
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------


def compare(torch, out, ref):
    """(max abs error, max over rows of the row's max abs error / the
    reference row's RMS). A row whose reference is all zero (it sees no
    key) must come out exactly zero."""
    diff = (out.float() - ref.float()).abs()
    row_err = diff.amax(-1)
    row_rms = ref.float().pow(2).mean(-1).sqrt()
    live = row_rms > 0
    rel = (row_err[live] / row_rms[live]).max().item() if live.any() else 0.0
    if bool((row_err[~live] > 0).any()):
        rel = float("inf")
    return diff.max().item(), rel


def check_flash(torch, mods, a, iters=10, library=False, block_q=None):
    """Kernel 1 against its plain version (block_q query rows at a time) on
    the arguments `a` of one flash_attention call (q, k, v, spans, causal,
    softcap, offsets, lse)."""
    fa = mods["flash"]
    q, k, v, spans = a["q"], a["k"], a["v"], a["spans"]
    q_off, kv_off = int(a["q_offset"] or 0), int(a["kv_offset"] or 0)
    lse = bool(a["return_lse"])
    kw = dict(spans=spans, causal=a["causal"], softcap=a["softcap"], q_offset=q_off,
              kv_offset=kv_off, return_lse=lse)
    out = fa.flash_attention(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, spans, a["softcap"], q_off, kv_off,
                                            block_q)
    torch.cuda.synchronize()
    if lse:
        out, out_lse = out
    err, rel = compare(torch, out, ref)
    if lse:
        live = ref_lse > -1e29
        err = max(err, (out_lse[live] - ref_lse[live]).abs().max().item() if live.any() else 0.0)
        require(bool((out_lse[~live] < -1e29).all()), "flash lse of a fully masked row")
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, spans, a["softcap"], q_off, kv_off,
                                                     block_q), max(2, iters // 3))
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    visible = visible_pairs(torch, mods, b, nq, nkv, spans, q_off, kv_off)
    itemsize = q.element_size()
    nbytes = 2 * b * h * (nq + nkv) * d * itemsize + (b * h * nq * 4 if lse else 0)
    if spans is not None:
        nbytes += spans.numel() * 4
    bnd, by = bound_ms(nbytes, 4 * h * d * visible, str(q.dtype).split(".")[-1])
    sdpa = None  # its dense boolean mask does not fit at long lengths
    if nq * nkv <= 4096 * 4096:
        rows = torch.arange(nq, device="cuda") + q_off
        cols = torch.arange(nkv, device="cuda") + kv_off
        mask = mods["spans"].span_allowed(rows, cols, spans)  # [b|1, nq, nkv]
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None]), iters)
    lib = flex_ms(torch, q, k, v, spans, a["softcap"], q_off, kv_off, iters=iters)[0] \
        if library else None
    return dict(err=err, row_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                sdpa_no_softcap_ms=sdpa, library_ms=lib)


def check_decode(torch, mods, a, iters=20):
    """Kernel 2 against its plain version on the arguments `a` of one
    decode_attention call (q, k, v, bias, k_scale, v_scale, softcap, lens)."""
    da = mods["decode"]
    args = tuple(a[n] for n in ("q", "k", "v", "bias", "k_scale", "v_scale", "softcap", "lens"))
    q, k, lens = a["q"], a["k"], a["lens"]
    out = da.decode_attention(*args)
    ref = da.decode_attention_plain(*args).to(q.dtype)
    torch.cuda.synchronize()
    err, rel = compare(torch, out, ref)
    ms = time_ms(lambda: da.decode_attention(*args), iters)
    plain = time_ms(lambda: da.decode_attention_plain(*args), max(2, iters // 4))
    b, h, nq, d = q.shape
    int8 = a["k_scale"] is not None
    slots = int(lens.sum().item()) if lens is not None else b * k.shape[2]
    per_slot = h * d * k.element_size() * 2 + (h * 8 if int8 else 0) + 4  # K, V, scales, bias
    nbytes = slots * per_slot + 2 * b * h * nq * d * q.element_size() + 4 * b
    kind = "int8" if int8 else str(k.dtype).split(".")[-1]
    bnd, by = bound_ms(nbytes, 4 * h * nq * d * slots, kind)
    return dict(err=err, row_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)


def visible_pairs(torch, mods, b, nq, nkv, spans, q_off, kv_off, block=2048):
    """(query, key) pairs the mask lets through, summed over the batch (per
    head), counted block rows at a time."""
    cols = torch.arange(nkv, device="cuda") + kv_off
    total = 0
    for i in range(0, nq, block):
        rows = torch.arange(i, min(i + block, nq), device="cuda") + q_off
        mask = mods["spans"].span_allowed(rows, cols, spans)  # [b|1, rows, nkv]
        total += int(mask.sum().item()) * (b // mask.shape[0])
    return total


def flex_ms(torch, q, k, v, spans, softcap, q_off=0, kv_off=0, do=None, iters=10):
    """(forward ms, backward ms) of torch.compile'd flex_attention with the
    tanh softcap as score_mod and the span mask as block mask, on q/k/v
    [b,h,n,d]: the library yardstick of `library_ms`. (None, None) where it
    is not available; the reason is logged."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        # every yardstick compiles anew: past dynamo's recompile limit
        # flex_attention falls back to its eager version, which holds the
        # whole score matrix (16 GiB at n 16384)
        torch._dynamo.reset()
        b, h, nq, d = q.shape
        nkv = k.shape[2]
        sp = (torch.zeros((b, 0, 3), dtype=torch.int32, device="cuda") if spans is None
              else spans.to(torch.int32))
        off, ln = sp[..., 1], sp[..., 2]

        def mask_mod(bi, hi, qi, ki):
            i, j = qi + q_off, ki + kv_off
            ok = i >= j
            for s_ in range(sp.shape[1]):
                ok = ok | ((ln[bi, s_] > 0) & (i >= off[bi, s_]) & (j < off[bi, s_] + ln[bi, s_]))
            return ok

        def score_mod(score, bi, hi, qi, ki):
            return torch.tanh(score / softcap) * softcap

        # compiled: the eager mask would be materialized whole at long lengths
        block = create_block_mask(mask_mod, b, None, nq, nkv, device="cuda",
                                  **({"_compile": True} if nq * nkv > 4096 * 4096 else {}))
        # the timed backward re-runs one graph (retain_graph), which a
        # compiled backward with donated buffers refuses
        torch._functorch.config.donated_buffer = False
        flex = torch.compile(flex_attention)
        fwd = time_ms(lambda: flex(q, k, v, score_mod=score_mod, block_mask=block), iters)
        bwd = None
        if do is not None:
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = flex(qg, kg, vg, score_mod=score_mod, block_mask=block)
            bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                          iters)
        return fwd, bwd
    except Exception as e:  # a yardstick only: the port never calls it
        log(f"flex_attention yardstick unavailable: {type(e).__name__}: {str(e)[:300]}")
        return None, None


def grad_compare(torch, got, want):
    """(max abs error, max over dq/dk/dv of error / the gradient's largest
    element, max row error / row RMS)."""
    err = rel = row = 0.0
    for a, b in zip(got, want):
        e, r = compare(torch, a, b)
        err, row = max(err, e), max(row, r)
        rel = max(rel, e / max(b.float().abs().max().item(), 1e-30))
    return err, rel, row


def bwd_bound(torch, b, h, nq, nkv, d, itemsize, visible, extra_bytes=0):
    """Reads q, o, dO [nq] and k, v [nkv] and lse; writes dq, dk, dv: 5
    products of 2 d FLOPs per visible pair and head."""
    nbytes = itemsize * b * h * d * (4 * nq + 4 * nkv) + 4 * b * h * nq + extra_bytes
    return nbytes, 10 * h * d * visible


def check_flash_bwd(torch, mods, a, iters=5, library=False, block_q=None):
    """The backward kernel against its plain version (block_q query rows at
    a time) on the arguments `a` of one flash_attention call plus the
    output cotangent a['do'] (and an lse cotangent a['g_lse'] when given)."""
    fa = mods["flash"]
    q, k, v, spans, cap = a["q"], a["k"], a["v"], a["spans"], a["softcap"]
    q_off, kv_off = int(a["q_offset"] or 0), int(a["kv_offset"] or 0)
    do, g_lse = a["do"], a.get("g_lse")
    out, lse = fa.flash_attention(q, k, v, spans=spans, causal=a["causal"], softcap=cap,
                                  q_offset=q_off, kv_offset=kv_off, return_lse=True)
    args = (q, k, v, out, lse, do, spans, cap, q_off, kv_off, g_lse)
    got = fa.flash_attention_backward(*args)
    delta = (do.float() * out.float()).sum(-1) - (0 if g_lse is None else g_lse)
    pargs = (q, k, v, do, lse, delta, spans, cap, q_off, kv_off, block_q)
    want = fa.flash_attention_backward_plain(*pargs)
    torch.cuda.synchronize()
    err, rel, row = grad_compare(torch, got, want)
    ms = time_ms(lambda: fa.flash_attention_backward(*args), iters)
    plain = time_ms(lambda: fa.flash_attention_backward_plain(*pargs), max(2, iters // 3))
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    vis = visible_pairs(torch, mods, b, nq, nkv, spans, q_off, kv_off)
    extra = (0 if spans is None else spans.numel() * 4) + (0 if g_lse is None else 4 * b * h * nq)
    nbytes, ops = bwd_bound(torch, b, h, nq, nkv, d, q.element_size(), vis, extra)
    bnd, by = bound_ms(nbytes, ops, str(q.dtype).split(".")[-1])
    lib = flex_ms(torch, q, k, v, spans, cap, q_off, kv_off, do, iters)[1] if library else None
    return dict(err=err, rel_err=rel, row_rel_err=row, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib)


def check_nhd(torch, mods, a, iters=5, library=False):
    """The token-major forward and backward kernels against their plain
    versions on the arguments `a` of one flash_attention_nhd call plus its
    output cotangent a['do']. Returns (forward result, backward result)."""
    fn = mods["nhd"]
    q, k, v, h, cos, sin = a["q"], a["k"], a["v"], a["h"], a["cos"], a["sin"]
    spans, cap, do = a["spans"], a["softcap"], a["do"]
    out, lse = fn._forward(q, k, v, h, cos, sin, spans, cap)
    ref, ref_lse = fn.flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, cap)
    got = fn.flash_attention_nhd_backward(q, k, v, out, lse, do, h, cos, sin, spans, cap)
    b, n, hd = q.shape
    d = hd // h
    delta = (do.float() * out.float()).view(b, n, h, d).sum(-1).transpose(1, 2)
    pargs = (q, k, v, do, lse, delta, h, cos, sin, spans, cap)
    want = fn.flash_attention_nhd_backward_plain(*pargs)
    torch.cuda.synchronize()
    f_err, f_row = compare(torch, out, ref)
    live = ref_lse > -1e29
    f_err = max(f_err, (lse[live] - ref_lse[live]).abs().max().item())
    b_err, b_rel, b_row = grad_compare(torch, got, want)
    kw = dict(cos=cos, sin=sin, spans=spans, causal=a["causal"], softcap=cap)
    f_ms = time_ms(lambda: fn.flash_attention_nhd(q, k, v, h, **kw), iters)
    f_plain = time_ms(lambda: fn.flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, cap),
                      max(2, iters // 3))
    bargs = (q, k, v, out, lse, do, h, cos, sin, spans, cap)
    b_ms = time_ms(lambda: fn.flash_attention_nhd_backward(*bargs), iters)
    b_plain = time_ms(lambda: fn.flash_attention_nhd_backward_plain(*pargs), max(2, iters // 3))
    vis = visible_pairs(torch, mods, b, n, n, spans, 0, 0)
    itemsize = q.element_size()
    rope_bytes = 0 if cos is None else 2 * 4 * b * n * d
    span_bytes = 0 if spans is None else spans.numel() * 4
    kind = str(q.dtype).split(".")[-1]
    fb, fby = bound_ms(itemsize * 4 * b * n * hd + 4 * b * h * n + rope_bytes + span_bytes,
                       4 * h * d * vis, kind)
    nbytes, ops = bwd_bound(torch, b, h, n, n, d, itemsize, vis, rope_bytes + span_bytes)
    bb, bby = bound_ms(nbytes, ops, kind)
    lib_f = lib_b = None
    if library:  # flex on the rotated q/k in the head-major layout
        heads = lambda t: t.view(b, n, h, d).transpose(1, 2)  # noqa: E731
        qr, kr = q, k
        if cos is not None:
            qr = fn._rope_tokens(q, cos, sin, h).to(q.dtype)
            kr = fn._rope_tokens(k, cos, sin, h).to(k.dtype)
        lib_f, lib_b = flex_ms(torch, heads(qr), heads(kr), heads(v), spans, cap,
                               do=heads(do), iters=iters)
    fwd = dict(err=f_err, row_rel_err=f_row, ms=f_ms, plain_ms=f_plain, bound_ms=fb,
               bound_by=fby, library_ms=lib_f)
    bwd = dict(err=b_err, rel_err=b_rel, row_rel_err=b_row, ms=b_ms, plain_ms=b_plain,
               bound_ms=bb, bound_by=bby, library_ms=lib_b)
    return fwd, bwd


def flash_case(torch, mods, b, h, n, d, dtype, spans, q_offset=0, kv_offset=0, lse=False,
               iters=10):
    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    return check_flash(torch, mods, dict(
        q=q, k=k, v=v, spans=spans, causal=True, softcap=50.0, q_offset=q_offset,
        kv_offset=kv_offset, return_lse=lse), iters)


def bwd_case(torch, mods, b, h, n, d, dtype, spans, q_offset=0, kv_offset=0, g_lse=False,
             iters=5, library=False):
    g = torch.Generator(device="cuda").manual_seed(n + d + 1)
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    a = dict(q=q, k=k, v=v, do=do, spans=spans, causal=True, softcap=50.0, q_offset=q_offset,
             kv_offset=kv_offset)
    if g_lse:
        a["g_lse"] = torch.randn(b, h, n, device="cuda", generator=g)
    return check_flash_bwd(torch, mods, a, iters, library)


def nhd_case(torch, mods, b, h, n, d, dtype, spans, iters=5):
    g = torch.Generator(device="cuda").manual_seed(n + d + 2)
    q, k, v, do = (torch.randn(b, n, h * d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    pos = mods["spans"].spans_to_rotary_positions(n, spans)
    ang = mods["rope"].rope_angles(pos, d)
    return check_nhd(torch, mods, dict(q=q, k=k, v=v, h=h, cos=torch.cos(ang),
                                       sin=torch.sin(ang), spans=spans, causal=False,
                                       softcap=50.0, do=do), iters)


def decode_case(torch, mods, b, h, nq, cap, d, dtype, lens_list, int8, iters=20):
    g = torch.Generator(device="cuda").manual_seed(nq + cap)
    q = torch.randn(b, h, nq, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(b, h, cap, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    valid = torch.arange(cap, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e30).float().contiguous()
    ks = vs = None
    if int8:
        k, ks = mods["layers"]._quantize_rows(k)
        v, vs = mods["layers"]._quantize_rows(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    return check_decode(torch, mods, dict(
        q=q, k=k, v=v, bias=bias, k_scale=ks, v_scale=vs, softcap=50.0, lens=lens), iters)


RESULTS = {"flash_fwd": [], "flash_bwd": [], "flash_fwd_nhd": [], "flash_bwd_nhd": [],
           "decode_attn": [], "flash_fwd_streamed": [], "flash_bwd_streamed": []}


def record(name, shape, res, dtype):
    """Log one kernel-vs-plain result and hold it to the dtype's limits:
    max abs error (backwards: relative to the gradient's largest element),
    and max row error over the reference row's RMS (so a kernel that drops
    part of a long row fails even where |out| is small)."""
    kind = str(dtype).split(".")[-1]
    log(json.dumps({"kernel": name, "shape": shape, **res}))
    if "rel_err" in res:
        require(res["rel_err"] <= BWD_REL_TOL[kind],
                f"{name} {shape}: max err / max |grad| {res['rel_err']} > {BWD_REL_TOL[kind]}")
    else:
        require(res["err"] <= TOL[kind], f"{name} {shape}: max abs err {res['err']} > {TOL[kind]}")
    require(res["row_rel_err"] <= ROW_REL_TOL[kind],
            f"{name} {shape}: row err / row RMS {res['row_rel_err']} > {ROW_REL_TOL[kind]}")
    RESULTS[name].append(res)
    return res


def phase_kernels(torch, mods):
    spans_of = lambda b, ls: torch.tensor(  # noqa: E731 — [text][image]... layouts
        [[[0, off, ln] for off, ln in ls]] * b, dtype=torch.int32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    for n, spans in ((256, [(33, 196)]), (1024, [(10, 196), (400, 196)]),
                     (4096, [(10, 196), (1500, 196), (3000, 196)])):
        record("flash_fwd", f"b2 h8 n{n} d64 bf16 spans{len(spans)}",
               flash_case(torch, mods, 2, 8, n, 64, bf16, spans_of(2, spans)), bf16)
    record("flash_fwd", "b2 h8 n1024 d64 bf16 q_off=512 kv_off=256 lse",
           flash_case(torch, mods, 2, 8, 1024, 64, bf16, spans_of(2, [(700, 196)]),
                      q_offset=512, kv_offset=256, lse=True), bf16)
    record("flash_fwd", "b2 h8 n1000 d64 f32 spans1",
           flash_case(torch, mods, 2, 8, 1000, 64, f32, spans_of(2, [(33, 196)]), iters=3), f32)

    lens4 = [8192, 5000, 1200, 37]
    for nq in (1, 196):
        for int8 in (False, True):
            record("decode_attn", f"b4 h8 nq{nq} cap8192 d64 bf16{' int8' if int8 else ''}",
                   decode_case(torch, mods, 4, 8, nq, 8192, 64, bf16, lens4, int8), bf16)
    record("decode_attn", "b4 h8 nq196 cap8192 d64 f32",
           decode_case(torch, mods, 4, 8, 196, 8192, 64, f32, lens4, False, iters=3), f32)
    # long-context text serving: where the kernel loses to its plain version
    lens8 = [8192 - 37 * i for i in range(8)]
    for int8 in (False, True):
        record("decode_attn", f"long context: b8 h8 nq1 cap8192 d64 bf16{' int8' if int8 else ''}",
               decode_case(torch, mods, 8, 8, 1, 8192, 64, bf16, lens8, int8), bf16)

    # training: the token-major route at the bench shape (the bench
    # packing's span at 40, length 196, and an empty one) and in float32
    for b, dtype in ((32, bf16), (4, f32)):
        fwd, bwd = nhd_case(torch, mods, b, 8, 256, 64, dtype, spans_of(b, [(40, 196), (0, 0)]))
        kind = str(dtype).split(".")[-1]
        record("flash_fwd_nhd", f"b{b} h8 n256 d64 {kind} rope spans2", fwd, dtype)
        record("flash_bwd_nhd", f"b{b} h8 n256 d64 {kind} rope spans2", bwd, dtype)
    # the head-major backward: n 1024 training, row 7's envelope (no main
    # path reaches it, so its library yardstick is timed here), ring
    # attention's offsets with an lse cotangent, d 128, ragged n with whole
    # rows masked (kv_off > q_off: rows 0..299 see no key, so dq is exactly
    # 0 there, and kv rows no query reaches get dk = dv = 0), ragged n in
    # float32 (the FMA kernels)
    groups4 = [(40 + 244 * i, 196) for i in range(4)]
    for shape, args, kw in (
        ("b8 h8 n1024 d64 bf16 spans4", (8, 8, 1024, 64, bf16, spans_of(8, groups4)), {}),
        ("b2 h8 n256 d32 bf16 spans1 (row 7)", (2, 8, 256, 32, bf16, spans_of(2, [(40, 196)])),
         {"library": True}),
        ("b2 h8 n1024 d64 bf16 q_off=512 kv_off=256 g_lse",
         (2, 8, 1024, 64, bf16, spans_of(2, [(700, 196)]), 512, 256, True), {}),
        ("b2 h8 n1000 d128 bf16 spans1", (2, 8, 1000, 128, bf16, spans_of(2, [(33, 196)])), {}),
        ("b2 h8 n1000 d64 bf16 q_off=0 kv_off=300 spans1 (masked rows)",
         (2, 8, 1000, 64, bf16, spans_of(2, [(700, 196)]), 0, 300), {}),
        ("b2 h8 n1000 d64 f32 spans1", (2, 8, 1000, 64, f32, spans_of(2, [(33, 196)])), {}),
    ):
        record("flash_bwd", shape, bwd_case(torch, mods, *args, **kw), args[4])


# ---------------------------------------------------------------------------
# phase 3: small float32 model, card vs CPU
# ---------------------------------------------------------------------------


def phase_reference(torch, Transfusion):
    import numpy as np

    gpu = Transfusion(device="cuda", dtype=torch.float32, seed=3, **SMALL_CFG)
    cpu = Transfusion(device="cpu", dtype=torch.float32, seed=3, **SMALL_CFG)
    cpu.core.load_state_dict({k: v.cpu() for k, v in gpu.core.state_dict().items()})
    prompts = [np.arange(1, n + 1) % 16 for n in (5, 40, 130)]
    toks = [m.generate_text_batch(prompts, max_new_tokens=12, temperature=0.0).cpu()
            for m in (gpu, cpu)]
    require(torch.equal(toks[0], toks[1]), f"greedy tokens card {toks[0]} vs cpu {toks[1]}")

    packed = gpu.pack([[np.asarray([gpu.sos_id, 3, 4, 5, 6], np.int32)]],
                      wrap_sos_eos=False, add_meta=False)
    last = [m._prefill_impl(packed, cap=128)[0].cpu() for m in (gpu, cpu)]
    err = (last[0] - last[1]).abs().max().item()
    require(err <= 1e-4, f"prefill logits card vs cpu: {err}")

    noise = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([gpu.som_ids[0]])], max_length=20, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0, cache_kv=True)
    lat = [next(o[1] for o in m.sample(**kw) if isinstance(o, tuple)) for m in (gpu, cpu)]
    lat_err = float(np.abs(lat[0] - lat[1]).max())
    require(lat_err <= 1e-3, f"sampled latents card vs cpu: {lat_err}")
    log(json.dumps({"reference": "small f32 model, card vs cpu", "tokens_equal": True,
                    "prefill_logits_err": err, "latents_err": lat_err}))


def phase_reference_training(torch, Transfusion, Trainer, mods):
    """One training step's loss and gradients of a small float32 model on
    the card (kernels) and on the CPU (plain versions), from the same
    weights and draws, for both attention routes; within 1e-4 (TF32 off)."""
    import numpy as np

    LossDraws = mods["transfusion"].LossDraws
    for route, cfg, fwd, bwd in (("head-major, 2 x 32", SMALL_CFG, "flash_fwd", "flash_bwd"),
                                 ("token-major, 2 x 64", SMALL_NHD_CFG, "flash_fwd_nhd",
                                  "flash_bwd_nhd")):
        gpu = Transfusion(device="cuda", dtype=torch.float32, seed=4, **cfg)
        cpu = Transfusion(device="cpu", dtype=torch.float32, seed=4, **cfg)
        cpu.core.load_state_dict({k: v.cpu() for k, v in gpu.core.state_dict().items()})
        rng = np.random.default_rng(1)
        batch = [[rng.integers(0, 16, 5).astype(np.int32),
                  (0, rng.standard_normal((4, 4, 8)).astype(np.float32)),
                  rng.integers(0, 16, 3).astype(np.int32)] for _ in range(4)]
        packed = cpu.pack(batch, shift_friendly=True)
        draws = cpu.make_draws(packed.to_torch("cpu"), torch.Generator().manual_seed(0))
        out = {}
        for m in (gpu, cpu):
            dev = m.device
            d = LossDraws(times=draws.times.to(dev), cfg_uniform=draws.cfg_uniform.to(dev),
                          noises=tuple(t.to(dev) for t in draws.noises))
            leaves = {k: t.requires_grad_(True) for k, t in Trainer(m).init_state().params.items()}

            def step(m=m, d=d, leaves=leaves, dev=dev):
                loss, _ = m._loss_impl(leaves, packed.to_torch(dev), d, m.prob_uncond)
                return loss, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)

            (loss, grads), counts = counted(mods, step)
            out[dev.type] = (loss.item(), [None if g is None else g.cpu() for g in grads], counts)
        loss_err = abs(out["cuda"][0] - out["cpu"][0])
        grad_err = max((a - b).abs().max().item()
                       for a, b in zip(out["cuda"][1], out["cpu"][1]) if a is not None)
        counts = out["cuda"][2]
        require(counts[fwd] > 0 and counts[bwd] > 0,
                f"training reference {route}: kernel launches {counts}")
        require(loss_err <= 1e-4 and grad_err <= 1e-4,
                f"training reference {route}: loss err {loss_err}, grad err {grad_err}")
        log(json.dumps({"reference": f"small f32 training step, card vs cpu, {route}",
                        "loss": out["cpu"][0], "loss_err": loss_err, "max_grad_err": grad_err,
                        "launches": counts}))


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------------


def serving_lengths():
    return [37, 160, 283, 406, 530, 653, 776, 900]


# kernels line entries counted by the TPU kernel-table row a head-major
# wrapper's launch stands in for (`launches_by_row`)
BY_ROW = {"flash_fwd_streamed": ("flash_fwd", 3), "flash_bwd_streamed": ("flash_bwd", 9)}


def counted(mods, fn):
    """Run fn with every kernel wrapper's launch counters set to 0; returns
    (result, {kernel name: launches}), the streamed entries from the
    launches by row."""
    import torch

    counters = mods["counters"]
    for fn_ in counters.values():
        fn_.launches = 0
        if hasattr(fn_, "launches_by_row"):
            fn_.launches_by_row = dict.fromkeys(fn_.launches_by_row, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {name: fn_.launches for name, fn_ in counters.items()}
    for name, (wrapper, row) in BY_ROW.items():
        counts[name] = counters[wrapper].launches_by_row[row]
    return out, counts


# kernel name -> the wrapper that `models/layers.py` calls
SPIED = {"flash_fwd": "flash_attention", "decode_attn": "decode_attention",
         "flash_fwd_nhd": "flash_attention_nhd"}


@contextlib.contextmanager
def capturing(torch, mods, want):
    """While open, keep a copy of the arguments of the first call the model
    makes to each wrapper named in `want` (as `models/layers.py` binds it)
    that want[name] accepts, and, when its output takes part in a backward
    pass, the output's cotangent as 'do'. The call itself goes on to the
    wrapper unchanged."""
    layers, seen, originals = mods["layers"], {}, {}
    for name, accept in want.items():
        attr = SPIED[name]
        orig = originals[attr] = getattr(layers, attr)

        def spy(*args, _orig=orig, _sig=inspect.signature(orig), _name=name, _accept=accept,
                **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            first = _name not in seen and _accept(bound.arguments)
            if first:
                seen[_name] = {k: x.detach().clone() if isinstance(x, torch.Tensor) else x
                               for k, x in bound.arguments.items()}
            out = _orig(*args, **kw)
            if first and isinstance(out, torch.Tensor) and out.requires_grad:
                def keep(g, _n=_name):
                    seen[_n]["do"] = g.detach().clone()
                out.register_hook(keep)
            return out

        setattr(layers, attr, spy)
    try:
        yield seen
    finally:
        for attr, orig in originals.items():
            setattr(layers, attr, orig)


def bias_is_prefix(bias):
    """True when every row's valid slots (bias 0) are a prefix of the cache."""
    valid = bias > -1e29
    return bool((valid.cummin(dim=-1).values == valid).all())


def shape_str(t):
    return "x".join(map(str, t.shape))


def check_main_path(torch, mods, name, calls, dtype, library=False):
    """Hold each kernel against its plain version on the tensors the main
    path gave it (captured from one call of the serving run)."""
    require(set(calls) == {"flash_fwd", "decode_attn"}, f"{name}: captured only {sorted(calls)}")
    out = {}
    fa, dc = calls["flash_fwd"], calls["decode_attn"]
    qs = shape_str
    out["flash_fwd"] = record("flash_fwd", f"main path, {name}: prefill q {qs(fa['q'])} "
                              f"spans {'none' if fa['spans'] is None else qs(fa['spans'])}",
                              check_flash(torch, mods, fa, library=library), dtype)
    kv = "int8" if dc["k_scale"] is not None else str(dc["k"].dtype).split(".")[-1]
    prefix = "prefix" if bias_is_prefix(dc["bias"]) else "non-prefix"
    out["decode_attn"] = record("decode_attn", f"main path, {name}: q {qs(dc['q'])} "
                                f"cache {qs(dc['k'])} {kv}, {prefix} bias, "
                                f"lens {dc['lens'].tolist()}",
                                check_decode(torch, mods, dc), dtype)
    return out


def phase_serving(torch, Transfusion, mods):
    """Each path: a warm-up run that also captures one call of each kernel
    (checked against the plain version at those tensors), then the counted,
    timed run. Returns (launch totals, main-path kernel results)."""
    import numpy as np

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in serving_lengths()]
    b, new = len(prompts), 128
    totals = dict.fromkeys(KERNELS, 0)
    report, main = {}, {}

    for name, quant in (("generate_text_batch bf16 KV", False),
                        ("generate_text_batch int8 KV", True)):
        run = lambda k: model.generate_text_batch(  # noqa: E731
            prompts, max_new_tokens=k, temperature=0.0, kv_quantize=quant)
        # warm-up; its cache has the timed run's capacity (the width 1024
        # plus 2 or 128 new tokens both round up to 1152)
        with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                     "decode_attn": lambda a: True}) as calls:
            run(2)
        torch.cuda.synchronize()
        require(calls["decode_attn"]["k"].shape[2] == 1152, f"{name}: warm-up cache capacity")
        main[name] = check_main_path(torch, mods, name, calls, torch.bfloat16,
                                     library=not quant)
        t0 = time.perf_counter()
        run(1)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, counts = counted(mods, lambda: run(new))
        t_all = time.perf_counter() - t0
        toks = toks.cpu()
        require(tuple(toks.shape) == (b, new), f"{name}: tokens shape {tuple(toks.shape)}")
        require(bool(((toks >= 0) & (toks < 256)).all()), f"{name}: non-text token")
        require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0,
                f"{name}: kernel launches {counts}")
        for k in totals:
            totals[k] += counts[k]
        report[name] = dict(
            seconds=t_all, tokens_per_s=b * new / t_all,
            ms_per_decode_step=(t_all - t_prefill) / (new - 1) * 1e3,
            prefill_plus_one_step_ms=t_prefill * 1e3, launches=counts,
        )
        log(json.dumps({"serving": name, **report[name]}))

    name = "sample cache_kv cfg 3.0"
    prompt = [np.asarray(list(rng.integers(0, 256, size=24)) + [model.som_ids[0]], np.int32)]
    kw = dict(prompt=prompt, max_length=196, text_temperature=0.0, cache_kv=True,
              kv_quantize=False, cfg_scale=3.0, modality_steps=16,
              fixed_modality_shape=(14, 14), generator=torch.Generator("cuda").manual_seed(0))
    # warm-up (2 ODE steps, the same cache); captures an ODE evaluation over
    # the 196 latent rows
    with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                 "decode_attn": lambda a: a["q"].shape[2] == 196}) as calls:
        model.sample(**{**kw, "modality_steps": 2})
    torch.cuda.synchronize()
    # its prefill is the one main-path call in the batched envelope (row 1)
    main[name] = check_main_path(torch, mods, name, calls, torch.bfloat16, library=True)
    t0 = time.perf_counter()
    items, counts = counted(mods, lambda: model.sample(**kw))
    t_img = time.perf_counter() - t0
    lats = [it[1] for it in items if isinstance(it, tuple)]
    require(len(lats) >= 1, "sample: no modality was sampled")
    require(all(l.shape == (14, 14, 32) and np.isfinite(l).all() for l in lats),
            "sample: latents of the wrong shape or not finite")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0,
            f"sample: kernel launches {counts}")
    for k in totals:
        totals[k] += counts[k]
    report[name] = dict(seconds=t_img, images=len(lats), s_per_image=t_img / len(lats),
                        launches=counts)
    log(json.dumps({"serving": name, **report[name]}))
    return totals, main


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------


def bench_sample(rng, groups):
    """`bench.py`'s sample layout, [32 text][14x14x32 latent][8 text], once
    per group."""
    import numpy as np

    items = []
    for _ in range(groups):
        items += [rng.integers(0, 256, 32).astype(np.int32),
                  (0, rng.standard_normal((14, 14, 32)).astype(np.float32)),
                  rng.integers(0, 256, 8).astype(np.int32)]
    return items


def phase_training(torch, Transfusion, Trainer, mods):
    """Both attention routes of the training step at full width. Returns
    (launch totals, {kernel: main-path result})."""
    import numpy as np

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    trainer = Trainer(model, learning_rate=3e-4)
    depth = BENCH_CFG["transformer"]["depth"]
    rng = np.random.default_rng(0)
    runs = (
        ("bench batch 32 x [32 text][14x14x32][8 text], n 256, token-major", 32, 1, 257,
         "flash_fwd_nhd", "flash_bwd_nhd"),
        ("8 x 4 groups, n 1024, head-major", 8, 4, 1025, "flash_fwd", "flash_bwd"),
    )
    totals = dict.fromkeys(KERNELS, 0)
    main = {}
    for name, b, groups, n_packed, fwd, bwd in runs:
        batch = [bench_sample(rng, groups) for _ in range(b)]
        packed = model.pack(batch, shift_friendly=True)
        require(packed.text.shape[1] == n_packed, f"{name}: packed to {packed.text.shape}")
        packed = packed.to_torch("cuda")
        state = trainer.init_state()
        # one set of draws for every step, so that the losses compare like
        # with like
        draws = model.make_draws(packed, torch.Generator("cuda").manual_seed(0))
        with capturing(torch, mods, {fwd: lambda a: True}) as calls:
            state, _ = trainer.train_step(state, packed, draws=draws)
        torch.cuda.synchronize()
        require(fwd in calls and "do" in calls[fwd], f"{name}: no attention call captured")
        a = calls[fwd]
        if fwd == "flash_fwd_nhd":
            shape = f"main path, {name}: q {shape_str(a['q'])} rope spans {shape_str(a['spans'])}"
            f_res, b_res = check_nhd(torch, mods, a, library=True)
            main[fwd] = record(fwd, shape, f_res, torch.bfloat16)
        else:
            shape = f"main path, {name}: q {shape_str(a['q'])} spans {shape_str(a['spans'])}"
            main[fwd] = record(fwd, shape, check_flash(torch, mods, a, iters=5, library=True),
                               torch.bfloat16)
            b_res = check_flash_bwd(torch, mods, a, library=True)
        main[bwd] = record(bwd, shape, b_res, torch.bfloat16)

        def steps(state=state, packed=packed, draws=draws):
            losses = []
            for _ in range(TRAIN_STEPS):
                state, metrics = trainer.train_step(state, packed, draws=draws)
                losses.append(metrics["loss"])
            return [float(x) for x in losses]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, counts = counted(mods, steps)
        dt = time.perf_counter() - t0
        require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"{name}: loss did not fall {losses[0]} -> {losses[-1]}")
        want = depth * TRAIN_STEPS
        require(counts[fwd] == want and counts[bwd] == want,
                f"{name}: launches {counts}, want {want} of {fwd} and {bwd}")
        for k in totals:
            totals[k] += counts[k]
        log(json.dumps({
            "training": name, "steps": TRAIN_STEPS, "seconds": dt,
            "ms_per_step": dt / TRAIN_STEPS * 1e3,
            "packed_tokens_per_s": int(packed.total_tokens) * TRAIN_STEPS / dt,
            "tokens_per_step": int(packed.total_tokens), "loss_first": losses[0],
            "loss_last": losses[-1], "launches": counts,
        }))
    return totals, main


# ---------------------------------------------------------------------------
# phase 6: long-context training of the 573M config
# ---------------------------------------------------------------------------


def long_sample(rng):
    """LONG_GROUPS x ([600 text][14x14x32 latent]) then LONG_TAIL text."""
    import numpy as np

    items = []
    for _ in range(LONG_GROUPS):
        items += [rng.integers(0, 50_000, 600).astype(np.int32),
                  (0, rng.standard_normal((14, 14, 32)).astype(np.float32))]
    return items + [rng.integers(0, 50_000, LONG_TAIL).astype(np.int32)]


def phase_long_training(torch, Transfusion, Trainer, mods):
    """The 573M config at n 16384 with remat, chunked CE and grad
    accumulation 2. Returns (launch totals, {kernel: main-path result})."""
    import numpy as np

    name = "573M, 2 x n 16384, remat full, ce_chunk 256, grad_accumulation 2"
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **LONG_CFG)
    trainer = Trainer(model, learning_rate=3e-4, grad_accumulation=2)
    depth = LONG_CFG["transformer"]["depth"]
    rng = np.random.default_rng(0)
    packs = [model.pack([long_sample(rng)], shift_friendly=True) for _ in range(2)]
    for p in packs:
        require(p.text.shape[1] == LONG_N, f"{name}: packed to {p.text.shape}")
        require(p.spans.shape[1] == LONG_GROUPS, f"{name}: {p.spans.shape[1]} spans")
    packs = [p.to_torch("cuda") for p in packs]
    tokens = sum(int(p.total_tokens) for p in packs)
    state = trainer.init_state()
    n_params = sum(t.numel() for t in state.params.values())
    # one set of draws (one per microbatch) for every step
    gen = torch.Generator("cuda").manual_seed(0)
    draws = [model.make_draws(p, gen) for p in packs]

    with capturing(torch, mods, {"flash_fwd": lambda a: True}) as calls:
        state, _ = trainer.train_step(state, packs, draws=draws)
    torch.cuda.synchronize()
    require("flash_fwd" in calls and "do" in calls["flash_fwd"],
            f"{name}: no attention call captured")
    a = calls.pop("flash_fwd")
    shape = (f"main path, {name}: q {shape_str(a['q'])} spans {shape_str(a['spans'])}, "
             f"plain in blocks of {LONG_BLOCK_Q} rows")
    main = {
        "flash_fwd_streamed": record("flash_fwd_streamed", shape, check_flash(
            torch, mods, a, iters=3, library=True, block_q=LONG_BLOCK_Q), torch.bfloat16),
        "flash_bwd_streamed": record("flash_bwd_streamed", shape, check_flash_bwd(
            torch, mods, a, iters=3, library=True, block_q=LONG_BLOCK_Q), torch.bfloat16),
    }
    del a, calls

    # one step under remat 'dots' from the state the timed steps start at:
    # the same forward, another recomputation (its model is dropped after)
    dots_cfg = dict(LONG_CFG, transformer=dict(LONG_CFG["transformer"], remat_policy="dots"))
    dots = Trainer(Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **dots_cfg),
                   learning_rate=3e-4, grad_accumulation=2)
    t0 = time.perf_counter()
    metrics = dots.train_step(state, packs, draws=draws)[1]  # its new state is dropped
    dots_loss, dots_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    dots_s = time.perf_counter() - t0
    del dots, metrics
    torch.cuda.empty_cache()

    box = [state]  # the timed steps hold one state at a time
    del state

    def steps():
        losses, norms = [], []
        for _ in range(LONG_STEPS):
            box[0], metrics = trainer.train_step(box[0], packs, draws=draws)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        return [float(x) for x in losses], [float(x) for x in norms]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (losses, norms), counts = counted(mods, steps)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{name}: loss did not fall {losses[0]} -> {losses[-1]}")
    want_f, want_b = 2 * depth * 2 * LONG_STEPS, depth * 2 * LONG_STEPS
    require(counts["flash_fwd_streamed"] == counts["flash_fwd"] == want_f
            and counts["flash_bwd_streamed"] == counts["flash_bwd"] == want_b,
            f"{name}: launches {counts}, want {want_f} streamed forwards and {want_b} "
            "streamed backwards and no other")
    log(json.dumps({
        "training": name, "params": n_params, "steps": LONG_STEPS, "seconds": dt,
        "ms_per_step": dt / LONG_STEPS * 1e3, "packed_tokens_per_s": tokens * LONG_STEPS / dt,
        "tokens_per_step": tokens, "positions_per_step": 2 * (LONG_N - 1),
        "peak_memory_gb": peak / 1e9, "losses": losses, "grad_norms": norms,
        "launches": counts,
    }))
    rel = abs(dots_loss - losses[0]) / abs(losses[0])
    norm_rel = abs(dots_norm - norms[0]) / norms[0]
    log(json.dumps({"training": f"{name}, the first step under remat 'dots'",
                    "seconds": dots_s, "loss": dots_loss, "loss_rel_diff_to_full": rel,
                    "grad_norm_rel_diff_to_full": norm_rel}))
    require(rel <= 1e-3, f"{name}: remat 'dots' loss {dots_loss} vs 'full' {losses[0]}")
    require(norm_rel <= 1e-2,
            f"{name}: remat 'dots' grad norm {dots_norm} vs 'full' {norms[0]}")
    return {k: counts[k] for k in BY_ROW}, main


KERNELS = {
    "flash_fwd": dict(
        source="transfusion_tpu_torch/csrc/flash_fwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:345",
    ),
    "flash_bwd": dict(
        source="transfusion_tpu_torch/csrc/flash_bwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:966",
    ),
    "flash_fwd_nhd": dict(
        source="transfusion_tpu_torch/csrc/flash_fwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:1263",
    ),
    "flash_bwd_nhd": dict(
        source="transfusion_tpu_torch/csrc/flash_bwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:1333",
    ),
    "decode_attn": dict(
        source="transfusion_tpu_torch/csrc/decode_attn.cu",
        replaces="transfusion_tpu/ops/pallas_decode_kernel.py:164",
    ),
    # the same kernels as flash_fwd / flash_bwd, at the TPU's streamed
    # envelope (launches counted by row on the long-context run only)
    "flash_fwd_streamed": dict(
        source="transfusion_tpu_torch/csrc/flash_fwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:258",
    ),
    "flash_bwd_streamed": dict(
        source="transfusion_tpu_torch/csrc/flash_bwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:868",
    ),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from transfusion_tpu_torch import Transfusion
        from transfusion_tpu_torch.models import layers, transfusion
        from transfusion_tpu_torch.ops import (
            _build,
            decode_attn,
            flash_attn,
            flash_attn_nhd,
            rope,
            spans,
        )
        from transfusion_tpu_torch.training import Trainer
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    counters = {
        "flash_fwd": flash_attn.flash_attention,
        "flash_bwd": flash_attn.flash_attention_backward,
        "flash_fwd_nhd": flash_attn_nhd.flash_attention_nhd,
        "flash_bwd_nhd": flash_attn_nhd.flash_attention_nhd_backward,
        "decode_attn": decode_attn.decode_attention,
    }
    mods = dict(flash=flash_attn, nhd=flash_attn_nhd, decode=decode_attn, layers=layers,
                spans=spans, rope=rope, transfusion=transfusion, counters=counters)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)

    t0 = time.perf_counter()
    _build.build_all()
    log(json.dumps({"build_seconds": time.perf_counter() - t0}))
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.ptxas_log(name).splitlines() if "registers" in ln]
        log(f"ptxas {name}: {regs}")

    def timed_phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(json.dumps({"phase": fn.__name__, "seconds": time.perf_counter() - t}))
        return out

    timed_phase(phase_kernels, torch, mods)
    timed_phase(phase_reference, torch, Transfusion)
    timed_phase(phase_reference_training, torch, Transfusion, Trainer, mods)
    launches, main_path = timed_phase(phase_serving, torch, Transfusion, mods)
    train_launches, train_path = timed_phase(phase_training, torch, Transfusion, Trainer, mods)
    long_launches, long_path = timed_phase(phase_long_training, torch, Transfusion, Trainer,
                                           mods)

    # the kernels line: launches over the serving and training runs (the
    # streamed entries: over the long-context run); times on the tensors
    # captured from the text path with bf16 KV (flash_fwd, decode_attn),
    # from the training runs (the backward and token-major kernels) and from
    # the long-context run (the streamed entries)
    timed = {**train_path, **main_path["generate_text_batch bf16 KV"], **long_path}
    kernels = []
    for name, meta in KERNELS.items():
        total = (launches.get(name, 0) + train_launches.get(name, 0)
                 + long_launches.get(name, 0))
        require(total > 0, f"{name} was not launched on the main paths")
        m = timed[name]
        kernels.append(dict(
            name=name, route="cuda", **meta, launches=total,
            max_abs_err=max(r["err"] for r in RESULTS[name]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m.get("library_ms"),
        ))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
