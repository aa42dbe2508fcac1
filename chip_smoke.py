#!/usr/bin/env python3
"""Drive the PyTorch port (`transfusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build: compile every CUDA kernel of the port from
     `transfusion_tpu_torch/csrc/` (one nvcc per source, in parallel);
     print the card's name and power limit;
  2. kernels vs plain: each kernel against its plain PyTorch version on the
     same inputs, at synthetic shapes around the main paths' and at head
     dims 32 to 256, whole rows masked, row 1's envelope, 200 spans a row,
     b * h past 65535, logits near the softcap, a row that sees one key
     and whose dO . v cancels (its ds is rounding noise, which must agree
     with the plain version's), LASER's exp-space values
     (exp(softclamp(6 N(0, 1), 15)), up to e^15; forward outputs held by
     the row rule and after safe_log, the backward under do = g / out), the
     decode kernel's every path with whole chunks past lens and rows with
     no valid slot, and the
     kernels a decode call enqueues (1 or 2, by the wrapper's own counter;
     the profiler names them and must see no more than 2) (forwards:
     bf16 within 2e-2, float32 within 1e-4 max abs error; every row's max
     error also within 0.08 (bf16) / 1e-3 (float32) of that row's RMS;
     backwards: dq/dk/dv within 1e-2 (bf16) / 1e-4 (float32) of the
     gradient's largest element, rows as the forwards; a backward past the
     row rule saves its capture under build/ and logs its worst rows:
     RMS, error, how far the row cancels and what rounding the kernel's
     bf16 operands alone gives it), with kernel ms, plain ms and the
     card's bound;
  3. reference: a small float32 model on the card (kernels) against the
     same weights on the CPU (plain versions): prefill logits, greedy
     tokens and sampled latents must agree (cached and uncached `sample`
     with CFG 3.0, `sample_batch` over a text, a [som] and a modality
     prompt, `generate_modality_only`: tokens equal, latents within 1e-3),
     both serving engines (the text engine with a request that fills its
     row exactly, the multimodal engine through a capacity rebuild; tokens
     equal, latents within 1e-3), one training step's loss and every
     gradient (head-major and token-major attention) within 1e-4, and a
     small image model (patch codec, U-Net halves, pos-emb): one step's
     loss, its velocity and reconstruction terms and every gradient within
     1e-4, cached `sample` latents and decoded images within 1e-3; and a
     small model with LASER, 4 residual streams and fused projections: one
     `Trainer(optimizer=muon_adam_atan2(...))` step's loss and every
     gradient within 1e-4, its new parameters (Muon's bf16 Newton-Schulz:
     each matrix's step within 0.5 of the CPU step's Frobenius norm; the
     Adam-atan2 rest within 1e-5 but for at most 0.1 % of entries whose ~0
     gradient takes its sign from rounding, each within 4 lr), cached
     `sample` tokens equal and latents within 1e-3 with no decode launch;
  4. serving: the bench model at full width (dim 384, depth 8, 8x64 heads,
     bf16, seeded weights) through `generate_text_batch` (8 ragged prompts,
     128 new tokens, greedy; bf16 and int8 KV) and `sample(cache_kv=True)`
     with CFG; then the 573M config (phase 6's) through `generate_text_batch`
     on 8 long ragged prompts (850-8192 tokens, width 8192, cache capacity
     8320, 32 new tokens, greedy; bf16 and int8 KV). Each path's warm-up
     captures the tensors of one prefill and one decode call, and each
     kernel is held against its plain version on them (as in phase 2; the
     long prefill's plain version 1024 query rows at a time). Then the path
     runs with the launch counters set to 0 and must launch both kernels;
  4b. sampling: the same bench model through uncached `sample()` (CFG 3.0,
     16 midpoint steps, 14x14, 16 text tokens after the image; one captured
     flash call against its plain version, its route logged; latents
     against `sample(cache_kv=True)` within atol 0.15 + rtol 0.05),
     `sample_batch` over 8 requests (16 pool rows: 4 prompts of 24-200
     tokens ending in [som], 4 of 16-900 text tokens; 196 + 32 tokens
     each, text chunks of 32; decode calls at nq 1 and 196 over the 16
     rows captured and held against the plain version; every chunk runs
     with CUDA's sync debug mode at 'error' and is read back by one fetch;
     each request against its solo `sample(cache_kv=True)`: latents within
     the bf16 limits, sampled tokens at least 95 % equal to the greedy
     choice of a forward of their own history), `generate_modality_only`
     (b8 14x14) and the adaptive ODE (`sample_batch` of 2 requests in
     float32, which must finish within max_steps);
  4c. engines: the same bench model through the continuous-batching
     engines. `ServingEngine` (8 rows, chunks up to 64, greedy) over 24
     requests of 16-900 prompt tokens (16 budgets of 16-64 new tokens, 8 of
     128-256): `warmup(fit_cap_slope=True)`, `run()`, then `serve()` on the
     same workload (the planner's choice, both estimates and the fitted
     cost model logged). `MultimodalServingEngine` (4 requests, 8 pool rows,
     CFG 3.0, 16 midpoint steps, 14x14, chunks up to 32) over phase 4b's 8
     requests: `warmup()`, `run()`. Each engine's admission prefill and its
     decode calls (nq 1; the multimodal one also nq 196) are captured and
     held against the plain versions; every chunk runs under sync debug
     'error' and is read back by one fetch; greedy tokens agree with a
     forward of their own history at >= 95 % of positions, each image
     request's latents lie within the bf16 limits of its solo
     `sample(cache_kv=True)`, and no pool rebuild fires;
  4d. image model: the same bench model with the image workloads' options
     (a 2 x 2 patch encoder / decoder of [28, 28, 8] images, U-Net halves
     from `models/modality_io.py` that take the 14x14x32 latents to 7 x 7
     = 49 rows, axial pos-emb, reconstruction and velocity-consistency
     weights 0.1): 20 `Trainer(velocity_consistency=True)` steps on 32 x
     [32 text][image][8 text] (the trained forward, the EMA forward and the
     backward once per layer and step; the EMA pass's share of a step
     logged; the loss falls), one `forward_modality` loss with both terms,
     then, on the seeded weights, cached `sample()` (CFG 3.0), `sample_batch`
     over phase 4b's 8 requests and the multimodal engine (4 requests, 8
     rows), each returning decoded images in [0, 1]; the captured flash
     and decode calls (row 4 at nq 49 among them) are held against their
     plain versions, batched latents lie within the bf16 limits of solo
     and greedy tokens agree per position at >= 95 %;
  4e. recipes: the same bench model with the example recipes' LASER
     attention and 4 residual streams of 4 fracs: 20
     `Trainer(optimizer=muon_adam_atan2(3e-4, 3e-4), grad_clip_norm=0.5)`
     steps on bench.py's batch (n 256, rows 5 and 6 once per layer a step;
     the loss falls; ms a step, packed tok/s and the optimizer update's ms
     logged), cached `sample()` with CFG 3.0 on the seeded weights (its
     row-1 prefill; no decode launch, the exclusion logged; s an image),
     then `examples/train_text_only.py` at its own width (vocab 256, flash,
     LASER): 8 calls of chain(clip 0.5, MultiSteps(adam(3e-4), 4)) through
     `_text_loss_impl` on 4 x 257 bytes (2 updates, the EMA every call) and
     `generate_text_batch` (its row-2 prefill). The captured LASER calls
     (v = exp(softclamp(v, 15)), up to e^15) hold every output row within
     the row rule and the outputs after safe_log within the forward
     tolerance; the backward as in phase 2;
  4f. the single-process user surface: (a) `PackingLoader` over 64
     bench-shaped samples (batch 32, prefetch 2; every batch from the
     native packer) feeding the bench model:
     `Trainer.train_steps(state, [b0, b1], 20)` over two of its batches (rows
     5 and 6 once per layer a step; the captured call held), then 10
     `train_step(next(loader))` calls, the waits in `next()` timed; one
     bench-shaped `pack_samples` call (32 samples) with use_native True and
     False: equal arrays, each one's host ms logged; (b)
     dropout: a small float32 dropout-0.1 model's joint forward and every
     gradient with the same keep masks, card against CPU within 1e-4, on the
     dense route (attention and feedforward masks) and the flash route; the
     bench model with dropout 0.1 gives its dropout-0 twin's cached
     `sample()` and `loss(train=False)` exactly, and `loss(train=True)` is
     refused; (c) the bench model exported as a transfusion-pytorch
     state_dict and loaded into a fresh model: logits bit-equal, cached
     `sample()` equal, its row-1 prefill, its decode call and a
     `generate_text_batch` row-2 prefill captured and held; (d) the ten
     example twins (`python -m transfusion_tpu_torch.examples.<name>
     --device cuda`: 3 steps sampling once, `train_mnist_vae` with 5
     autoencoder steps, `serve_text` at its defaults with every demo), all
     started together, each exit code checked, seconds and last loss logged;
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
  5m. latent attention: the flash kernels at q k 192 beside v 128 (kernel
     table rows 2m and 8m). Moonlight-16B-A3B's block at its published
     widths (d 2048, 16 heads, MLA, 64 routed experts of which 8 held),
     2 layers (one dense, one of experts), under remat 'full', through
     `Trainer.train_step` on 8 rows of 4096 positions with 5 caption-image
     pairs a row (16 x 16 x 32 latents), the moonlight-train-4k cell's
     shapes: the warm-up step captures one attention call, held in bf16
     and, cast, in float32 (forward and backward) against the plain
     versions in 1024-row blocks, with flex's times in bf16; one b1 h16
     n8192 causal call (the context) the same way; then LATENT_STEPS steps
     with the counters set to 0 must launch the forward 2 x depth times a
     step (remat's recompute) and the backward depth times;
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
  parallel. context parallelism and the mesh trainer, on one card: (a) the
     ring and all-gather schedules of 4 ranks, run one rank after another
     (`parallel/context.py`'s `ring_local` / `allgather_local`, the chunks
     a rank would receive sliced from the whole K/V) on phase 6's captured
     n 16384 call, forward and backward: the assembled output against the
     whole-sequence kernel call, dq / dk / dv against the whole-sequence
     backward kernel at the schedule's own output and lse (the bounds of
     phase 2), launches by TPU row (ring: rows 2 / 8; all-gather: 3 / 9),
     chunks skipped, ms against the whole call; (b) the bench model with
     attn_impl 'ring' under `Trainer(mesh=make_mesh())` on a one-rank NCCL
     group for 20 steps (loss finite and falling, the first step equal to
     a mesh-less flash step within 1e-3, one forward and one backward
     launch per layer per step), then the twin of
     `examples/train_distributed.py` under torchrun with one rank (its exit
     code checked). Communication between ranks is held on the CPU only
     (tests/test_torch_distributed.py, gloo);
  pipeline. pipeline parallelism with the P stages in this one process
     (`parallel.pipeline.LocalStages`, the engines' own schedule code with
     the carries handed over in memory), through `Transfusion.loss(
     pipeline=(LocalStages(P), M, schedule))` and the Trainer's own fused
     clip + Adam + EMA update: (a) the bench model with unet_skips=False on
     bench (a)'s batch (32 x n 256, token-major), P 4 stages of 2 layers, M
     8 microbatches of 4 rows, GPipe and 1F1B, PIPE_STEPS steps each from
     the same weights and draws: the first step's loss within 1e-3
     relative of the unpipelined step's, every gradient within
     PIPE_GRAD_REL_TOL (relative Frobenius) of its gradients, the loss
     falling, the token-major rows 5 / 6 launched depth x M times a step
     each (1F1B: row 5 twice that, its backward recomputing each stage from
     its saved input), and one captured stage call of each schedule
     (q 4 x 256 x 512) held against the plain versions of rows 5 and 6; (b) the 573M config with unet_skips=False at 4 x
     n 16384, P 4 stages of 3 layers, M 4, 1F1B, one step: its loss within
     1e-3 of the unpipelined `Trainer(grad_accumulation=4)` step on the same
     rows and draws, rows 3 / 9 launched 3 x depth x M / depth x M times
     (remat runs each recomputed stage's forward twice), the process's peak
     memory (all 4 stages' together, not one rank's), and one captured
     stage call of rows 3 and 9 held against the plain versions in 1024-row
     blocks as in phase 6. One card cannot check NCCL point-to-point
     between ranks, the bubble's time, or one rank's peak memory
     (tests/test_torch_pipeline_distributed.py runs 4 gloo ranks on the
     CPU);
  sharded optimizer. a custom optimizer chain on a mesh that shards
     parameters: 4 processes (`torch.multiprocessing`, spawned) join a gloo
     group, every one on the one card (NCCL takes one rank per device),
     and run the bench model under `Trainer(mesh=make_mesh(fsdp=2,
     tensor=2, device="cuda"), optimizer=chain(clip_by_global_norm(0.5),
     muon_adam_atan2(3e-4, 3e-4)), grad_clip_norm=None)` for 5 steps on
     bench (a)'s batch (4 heads a rank): every rank the same losses, which
     fall; the first loss and grad_norm within 1e-3 relative of a
     mesh-less Trainer's with the same chain, weights and draws on the
     card; after step 1 every rank's shards beside that Trainer's new
     masters (Muon matrices within MUON_REL_TOL of its step, the rest
     within 1e-3 with at most SHARD_FLIP_SHARE of the entries past 1e-5);
     the route's rows launched once per layer, step and rank (logged:
     5 / 6 token-major or 1-2 / 8 head-major); one captured call on the 4
     heads held against its plain versions; a save on every rank and a
     restore by a new Trainer give back every shard of the params, EMA
     and optimizer state exactly. Logs ms a step and the update's ms of
     each rank (4 ranks share the card: no per-card rate);
  7. the card's name and power limit again, the `kernels` line, then the
     last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`library_ms` in the kernels line is `torch.compile`d `flex_attention` with a
tanh `score_mod` and the span block mask on the same tensors (for the
token-major route: on the rotated, head-major q/k, so without the RoPE and
layout work the kernels also do; for decode: the tanh plus the validity
bias as `score_mod` and lens as the mask, bf16 and float32 caches only); it
is a yardstick, and the port never calls it.

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
# phase 4d: the bench model with the image workloads' options
# (examples/train_image_only_with_unet.py:52-60, train_latent_with_text.py:41-47):
# [28, 28, 8] images in [0, 1], 2 x 2 patches to the bench's [14, 14, 32]
# latents, a stride-2 conv / transposed conv U-Net to 7 x 7 = 49 rows
IMAGE_OPTS = dict(add_pos_emb=True, modality_num_dim=2, reconstruction_loss_weight=0.1,
                  velocity_consistency_loss_weight=0.1)
IMAGE_SHAPE, IMAGE_ROWS = (28, 28, 8), 49
# scripts/probe_573m.py:29-41, unchanged
LONG_CFG = dict(
    num_text_tokens=50_000, dim_latent=32, modality_default_shape=(14, 14), pad_multiple=64,
    ce_chunk_size=256,
    transformer=dict(dim=1024, depth=12, dim_head=64, heads=16, attn_impl="flash",
                     remat=True, remat_policy="full"),
)
LONG_GROUPS, LONG_TAIL, LONG_N = 20, 270, 16385  # packed length before the shift
LONG_STEPS = 4
# phase 5m: Moonlight-16B-A3B's published widths (config.json), 2 layers
LATENT_MOONLIGHT = dict(
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    intermediate_size=11264, moe_intermediate_size=1408, n_routed_experts=64, experts_held=8,
    num_experts_per_tok=6, n_shared_experts=2, routed_scaling_factor=2.446,
    first_k_dense_replace=1, rms_norm_eps=1e-5)
LATENT_CFG = dict(
    num_text_tokens=512, dim_latent=32, modality_default_shape=(16, 16),
    transformer=dict(dim=2048, depth=2, heads=16, block="moonlight", moonlight=LATENT_MOONLIGHT,
                     rope_theta=50000.0, attn_impl="flash", remat=True, remat_policy="full"),
)
LATENT_STEPS = 3
LONG_BLOCK_Q = 1024  # query rows per block of the plain versions at n 16384
# phase 4's long-prompt serving run on LONG_CFG: 8 ragged prompts, width 8192
LONG_PROMPTS = [8192, 7150, 6100, 5050, 4000, 2950, 1900, 850]
LONG_NEW = 32


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


def laser_log_err(torch, out, ref):
    """A LASER call's outputs after the model's safe_log: max abs error."""
    log = lambda t: torch.log(t.float().clamp_min(1e-20))  # noqa: E731
    return (log(out) - log(ref)).abs().max().item()


def check_flash(torch, mods, a, iters=10, library=False, block_q=None, laser=False):
    """Kernel 1 against its plain version (block_q query rows at a time) on
    the arguments `a` of one flash_attention call (q, k, v, spans, causal,
    softcap, offsets, lse). With `laser` (v = exp(softclamp(v, 15)), up to
    e^15) `err` is the error after safe_log, `exp_space_err` the raw one;
    the row rule holds the raw outputs."""
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
    extra = {}
    if laser:
        extra = dict(laser=True, exp_space_err=err)
        err = laser_log_err(torch, out, ref)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, spans, a["softcap"], q_off, kv_off,
                                                     block_q), max(2, iters // 3))
    b, h, nq, d = q.shape
    nkv, dv = k.shape[2], v.shape[-1]
    visible = visible_pairs(torch, mods, b, nq, nkv, spans, q_off, kv_off)
    itemsize = q.element_size()
    nbytes = b * h * (nq + nkv) * (d + dv) * itemsize + (b * h * nq * 4 if lse else 0)
    if spans is not None:
        nbytes += spans.numel() * 4
    bnd, by = bound_ms(nbytes, 2 * h * (d + dv) * visible, str(q.dtype).split(".")[-1])
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
                sdpa_no_softcap_ms=sdpa, library_ms=lib, **extra)


def kernels_per_call(torch, fn, calls=10, attempts=5):
    """(device kernels and copies a call of fn launches, their names),
    counted by the profiler over `calls` calls after a warm-up call. The
    profiler drops device events now and then (a window may even come back
    empty or short of one event a call), so a count is a lower bound, good
    for names and as an upper-bound check only: the most of up to
    `attempts` windows, stopping at the first that saw at least one a
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, names = 0.0, []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(seen) / calls > best:
            best, names = len(seen) / calls, sorted({n[:60] for n in seen})
        if best >= 1:
            break
    return best, names


def flex_decode_ms(torch, mods, a, iters=20):
    """(ms, max abs error against the plain version) of torch.compile'd
    flex_attention computing the decode kernel's function on the same
    tensors: score_mod cap * tanh(s / cap) + bias[b, kv], lens as the
    mask_mod. (None, None) for an int8 cache (no library call dequantizes
    it inside the kernel), or where flex fails; the reason is logged."""
    if a["k_scale"] is not None or a["k"].dtype != a["q"].dtype:
        log("flex_attention yardstick for decode_attn: none for an int8 cache or a cache in "
            "another dtype than q (no library call dequantizes it inside the kernel)")
        return None, None
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        torch._dynamo.reset()
        q, k, v, bias, cap = a["q"], a["k"], a["v"], a["bias"], float(a["softcap"])
        b, h, nq, d = q.shape
        n = k.shape[2]
        lens = a["lens"]
        if lens is None:
            lens = torch.full((b,), n, dtype=torch.int32, device="cuda")

        def mask_mod(bi, hi, qi, ki):
            return ki < lens[bi]

        def score_mod(score, bi, hi, qi, ki):
            return torch.tanh(score / cap) * cap + bias[bi, ki]

        block = create_block_mask(mask_mod, b, None, nq, n, device="cuda")
        flex = torch.compile(flex_attention)
        run = lambda: flex(q, k, v, score_mod=score_mod, block_mask=block)  # noqa: E731
        got = run()
        ref = mods["decode"].decode_attention_plain(
            q, k, v, bias, softcap=cap, lens=a["lens"]).to(q.dtype)
        live = lens > 0
        err = (got[live].float() - ref[live].float()).abs().max().item()
        return time_ms(run, iters), err
    except Exception as e:  # a yardstick only: the port never calls it
        log(f"flex_attention decode yardstick unavailable: {type(e).__name__}: {str(e)[:300]}")
        return None, None


def check_decode(torch, mods, a, iters=20, library=False, count=False):
    """Kernel 2 against its plain version on the arguments `a` of one
    decode_attention call (q, k, v, bias, k_scale, v_scale, softcap, lens);
    with `count`, also the kernels a call launches (at most 2: the split
    kernel and the merge)."""
    da = mods["decode"]
    args = tuple(a[n] for n in ("q", "k", "v", "bias", "k_scale", "v_scale", "softcap", "lens"))
    q, k, lens = a["q"], a["k"], a["lens"]
    out = da.decode_attention(*args)
    ref = da.decode_attention_plain(*args).to(q.dtype)
    torch.cuda.synchronize()
    err, rel = compare(torch, out, ref)
    ms = time_ms(lambda: da.decode_attention(*args), iters)
    plain = time_ms(lambda: da.decode_attention_plain(*args), max(2, iters // 4))
    extra = {}
    if count:
        # the wrapper's own count of the kernels it enqueued; the profiler
        # names them and bounds them from above (it may drop events, never
        # add them)
        calls = 10
        da.decode_attention.kernels = 0
        for _ in range(calls):
            da.decode_attention(*args)
        n = da.decode_attention.kernels / calls
        seen, names = kernels_per_call(torch, lambda: da.decode_attention(*args), calls)
        extra["kernels_per_call"], extra["profiler_kernels_per_call"] = n, seen
        require(1 <= n <= 2, f"decode_attention enqueued {n} kernels a call (1 or 2)")
        require(seen <= 2, f"the profiler saw {seen} device kernels a decode call (at most 2): "
                f"{names}")
    if library:
        extra["library_ms"], extra["library_max_abs_err"] = flex_decode_ms(torch, mods, a, iters)
    b, h, nq, d = q.shape
    int8 = a["k_scale"] is not None
    slots = int(lens.sum().item()) if lens is not None else b * k.shape[2]
    per_slot = h * d * k.element_size() * 2 + (h * 8 if int8 else 0) + 4  # K, V, scales, bias
    nbytes = slots * per_slot + 2 * b * h * nq * d * q.element_size() + 4 * b
    kind = "int8" if int8 else str(k.dtype).split(".")[-1]
    bnd, by = bound_ms(nbytes, 4 * h * nq * d * slots, kind)
    return dict(err=err, row_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                **extra)


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
        mod = score_mod if softcap else None  # softcap 0: no cap (latent attention)
        fwd = time_ms(lambda: flex(q, k, v, score_mod=mod, block_mask=block), iters)
        bwd = None
        if do is not None:
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = flex(qg, kg, vg, score_mod=mod, block_mask=block)
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


def bwd_bound(torch, b, h, nq, nkv, d, itemsize, visible, extra_bytes=0, dv=None):
    """Reads q, o, dO [nq] and k, v [nkv] and lse; writes dq, dk, dv: 5
    products per visible pair and head, 3 of 2 d FLOPs (s, dk, dq) and 2
    of 2 dv (dp, dv; dv the value width, d unless given)."""
    dv = d if dv is None else dv
    nbytes = itemsize * b * h * (2 * d + 2 * dv) * (nq + nkv) + 4 * b * h * nq + extra_bytes
    return nbytes, 2 * h * (3 * d + 2 * dv) * visible


def row_cancellation(torch, mods, a, lse, delta, grad, ix):
    """|sum of the terms| / sum of |terms| (RMS over d) of one row of dq (a
    query row) or dk / dv (a key row), from the float32 plain arithmetic:
    near 0 when the row's gradient cancels, so its RMS sits far below the
    terms that the kernel rounds."""
    q, k, v, do, sp, cap = a["q"], a["k"], a["v"], a["do"], a["spans"], a["softcap"]
    b, h, i = ix
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t[b, h].float() for t in (q, k, v, do))
    rows = torch.arange(q.shape[2], device=q.device) + int(a["q_offset"] or 0)
    cols = torch.arange(k.shape[2], device=q.device) + int(a["kv_offset"] or 0)
    if grad == "dq":
        s = (qf[i:i + 1] * scale) @ kf.T
        rows, lse_r, delta_r = rows[i:i + 1], lse[b, h, i:i + 1], delta[b, h, i:i + 1]
    else:
        s = (qf * scale) @ kf[i:i + 1].T
        cols, lse_r, delta_r = cols[i:i + 1], lse[b, h], delta[b, h]
    t = torch.tanh(s / cap) * cap
    allowed = mods["spans"].span_allowed(rows, cols, None if sp is None else sp[b:b + 1])[0]
    p = torch.where(allowed, torch.exp(t - lse_r.float()[:, None]), 0.0)
    if grad == "dv":
        terms = p * dof
    else:
        dp = dof[i:i + 1] @ vf.T if grad == "dq" else dof @ vf[i:i + 1].T
        ds = p * (dp - delta_r.float()[:, None]) * (1.0 - (t / cap) ** 2)
        terms = ds.T * kf * scale if grad == "dq" else ds * qf * scale
    return (terms.sum(0).norm() / terms.abs().sum(0).norm().clamp_min(1e-38)).item()


def diagnose_bwd_rows(torch, mods, a, got, want, lse, delta, block_q, worst=3):
    """A backward hold past the row rule: save its capture (q, k, v, do,
    lse, spans, offsets) under build/ and log the worst rows of dq, dk and
    dv: index, reference RMS, max error, the gradient's largest element,
    how far the row cancels (`row_cancellation`) and the error that
    rounding the kernel's bf16 operands alone gives on it
    (`backward_plain_f32(round_operands=bf16)` against float32)."""
    import numpy as np

    fa = mods["flash"]
    q_off, kv_off = int(a["q_offset"] or 0), int(a["kv_offset"] or 0)
    rounded = (None,) * 3
    if a["q"].dtype == torch.bfloat16:
        rounded = fa.backward_plain_f32(a["q"], a["k"], a["v"], a["do"], lse, delta, a["spans"],
                                        a["softcap"], q_off, kv_off, block_q,
                                        round_operands=torch.bfloat16)
    rows = []
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, rounded):
        err = (g.float() - w.float()).abs().amax(-1)
        rms = w.float().pow(2).mean(-1).sqrt()
        inf = torch.full_like(err, float("inf"))
        rel = torch.where(rms > 0, err / rms.clamp_min(1e-38), torch.where(err > 0, inf, 0.0))
        top = rel.flatten().topk(worst)
        for val, idx in zip(top.values.tolist(), top.indices.tolist()):
            ix = tuple(int(x) for x in np.unravel_index(idx, rel.shape))
            rows.append({
                "grad": name, "b_h_row": ix, "row_rel_err": val, "err": err[ix].item(),
                "ref_rms": rms[ix].item(), "grad_max": w.float().abs().max().item(),
                "cancellation": row_cancellation(torch, mods, a, lse, delta, name, ix),
                "rounding_rel_err": None if r is None else
                ((r[ix] - w[ix].float()).abs().max() / rms[ix].clamp_min(1e-38)).item(),
            })
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    path = os.path.join(HERE, "build", f"bwd_row_failure_{time.time_ns()}.pt")
    torch.save({k: a[k] for k in ("q", "k", "v", "do", "spans", "softcap", "causal", "q_offset",
                                  "kv_offset")} | {"lse": lse, "g_lse": a.get("g_lse")}, path)
    log(json.dumps({"bwd_row_rule_failure": os.path.relpath(path, HERE), "worst_rows": rows}))


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
    if row > ROW_REL_TOL[str(q.dtype).split(".")[-1]]:
        diagnose_bwd_rows(torch, mods, a, got, want, lse, delta, block_q)
    ms = time_ms(lambda: fa.flash_attention_backward(*args), iters)
    plain = time_ms(lambda: fa.flash_attention_backward_plain(*pargs), max(2, iters // 3))
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    vis = visible_pairs(torch, mods, b, nq, nkv, spans, q_off, kv_off)
    extra = (0 if spans is None else spans.numel() * 4) + (0 if g_lse is None else 4 * b * h * nq)
    nbytes, ops = bwd_bound(torch, b, h, nq, nkv, d, q.element_size(), vis, extra,
                            dv=v.shape[-1])
    bnd, by = bound_ms(nbytes, ops, str(q.dtype).split(".")[-1])
    lib = flex_ms(torch, q, k, v, spans, cap, q_off, kv_off, do, iters)[1] if library else None
    return dict(err=err, rel_err=rel, row_rel_err=row, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib)


def check_nhd(torch, mods, a, iters=5, library=False, laser=False):
    """The token-major forward and backward kernels against their plain
    versions on the arguments `a` of one flash_attention_nhd call plus its
    output cotangent a['do'] (without one, the forward alone); `laser` as
    in `check_flash`. Returns (forward result, backward result or None)."""
    fn = mods["nhd"]
    q, k, v, h, cos, sin = a["q"], a["k"], a["v"], a["h"], a["cos"], a["sin"]
    spans, cap, do = a["spans"], a["softcap"], a.get("do")
    out, lse = fn._forward(q, k, v, h, cos, sin, spans, cap)
    ref, ref_lse = fn.flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, cap)
    b, n, hd = q.shape
    d = hd // h
    if do is not None:
        got = fn.flash_attention_nhd_backward(q, k, v, out, lse, do, h, cos, sin, spans, cap)
        delta = (do.float() * out.float()).view(b, n, h, d).sum(-1).transpose(1, 2)
        pargs = (q, k, v, do, lse, delta, h, cos, sin, spans, cap)
        want = fn.flash_attention_nhd_backward_plain(*pargs)
    torch.cuda.synchronize()
    f_err, f_row = compare(torch, out, ref)
    extra = {}
    if laser:
        extra = dict(laser=True, exp_space_err=f_err)
        f_err = laser_log_err(torch, out, ref)
    live = ref_lse > -1e29
    f_err = max(f_err, (lse[live] - ref_lse[live]).abs().max().item())
    kw = dict(cos=cos, sin=sin, spans=spans, causal=a["causal"], softcap=cap)
    f_ms = time_ms(lambda: fn.flash_attention_nhd(q, k, v, h, **kw), iters)
    f_plain = time_ms(lambda: fn.flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, cap),
                      max(2, iters // 3))
    if do is not None:
        b_err, b_rel, b_row = grad_compare(torch, got, want)
        bargs = (q, k, v, out, lse, do, h, cos, sin, spans, cap)
        b_ms = time_ms(lambda: fn.flash_attention_nhd_backward(*bargs), iters)
        b_plain = time_ms(lambda: fn.flash_attention_nhd_backward_plain(*pargs),
                          max(2, iters // 3))
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
                               do=None if do is None else heads(do), iters=iters)
    fwd = dict(err=f_err, row_rel_err=f_row, ms=f_ms, plain_ms=f_plain, bound_ms=fb,
               bound_by=fby, library_ms=lib_f, **extra)
    if do is None:
        return fwd, None
    bwd = dict(err=b_err, rel_err=b_rel, row_rel_err=b_row, ms=b_ms, plain_ms=b_plain,
               bound_ms=bb, bound_by=bby, library_ms=lib_b)
    return fwd, bwd


def flash_case(torch, mods, b, h, n, d, dtype, spans, q_offset=0, kv_offset=0, lse=False,
               iters=10, laser=False):
    """With `laser`, v = exp(softclamp(6 N(0, 1), 15)) (up to e^15)."""
    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    if laser:
        v = torch.exp(torch.tanh(6 * v.float() / 15.0) * 15.0).to(dtype)
    return check_flash(torch, mods, dict(
        q=q, k=k, v=v, spans=spans, causal=True, softcap=50.0, q_offset=q_offset,
        kv_offset=kv_offset, return_lse=lse), iters, laser=laser)


def bwd_case(torch, mods, b, h, n, d, dtype, spans, q_offset=0, kv_offset=0, g_lse=False,
             iters=5, library=False, near_cap=False, cancel_row0=False):
    """near_cap: q row i is +-45 d^-1/2 (k_i + k_{i-1}) (rows alternate)
    with keys of norm d^1/2, so its logits q.k d^-1/2 on keys i and i - 1
    are equal and near +-45 (cap 50): the softmax of a + row splits between
    them (not one-hot, whose dp - delta cancels to rounding noise).
    cancel_row0: row 0 sees key 0 alone, so its ds is the rounding noise of
    dp - delta; its dO is small but for two entries whose products with
    v_0's (+-96 x 128) cancel exactly, so that dO . v_0 cancels too and its
    noise, 2^-10 of the partial sums, exceeds 2^-10 of delta: the kernel
    must still take dp in the plain version's order."""
    g = torch.Generator(device="cuda").manual_seed(n + d + 1)
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=g) for _ in range(4))
    if cancel_row0:
        do[:, :, 0] *= 2.0**-6
        v[:, :, 0, 40], v[:, :, 0, 41] = 128.0, 96.0
        do[:, :, 0, 40], do[:, :, 0, 41] = 96.0, -128.0
    if near_cap:
        k = k / k.norm(dim=-1, keepdim=True) * d**0.5
        pair = k + torch.cat([torch.zeros_like(k[:, :, :1]), k[:, :, :-1]], 2)
        sign = 2.0 * (torch.arange(n, device="cuda") % 2) - 1.0
        q = sign[:, None] * 45.0 * d**-0.5 * pair
    q, k, v, do = q.to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
    a = dict(q=q, k=k, v=v, do=do, spans=spans, causal=True, softcap=50.0, q_offset=q_offset,
             kv_offset=kv_offset)
    if g_lse:
        a["g_lse"] = torch.randn(b, h, n, device="cuda", generator=g)
    return check_flash_bwd(torch, mods, a, iters, library)


def nhd_case(torch, mods, b, h, n, d, dtype, spans, iters=5, laser=False):
    """With `laser`, LASER's exp-space values exp(softclamp(6 N(0, 1), 15))
    (up to e^15) and safe_log's cotangent do = g / out."""
    g = torch.Generator(device="cuda").manual_seed(n + d + 2)
    q, k, v, do = (torch.randn(b, n, h * d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    pos = mods["spans"].spans_to_rotary_positions(n, spans)
    ang = mods["rope"].rope_angles(pos, d)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if laser:
        v = torch.exp(torch.tanh(6 * v.float() / 15.0) * 15.0).to(dtype)
        ref, _ = mods["nhd"].flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, 50.0)
        do = (do.float() / ref.float().clamp_min(1e-20)).to(dtype)
    return check_nhd(torch, mods, dict(q=q, k=k, v=v, h=h, cos=cos, sin=sin, spans=spans,
                                       causal=False, softcap=50.0, do=do), iters, laser=laser)


def decode_case(torch, mods, b, h, nq, cap, d, dtype, lens_list, int8, iters=20, library=False,
                count=False):
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
        q=q, k=k, v=v, bias=bias, k_scale=ks, v_scale=vs, softcap=50.0, lens=lens), iters,
        library, count)


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
    # row 1's envelope (8 small heads, one tile each); whole rows masked
    # (kv_off > q_off: rows 0..299 see no key, so out is exactly 0 and lse
    # ~ -1e30); head dim 256 on both kernels
    record("flash_fwd", "b2 h8 n64 d64 bf16 spans2 (row 1)",
           flash_case(torch, mods, 2, 8, 64, 64, bf16, spans_of(2, [(10, 30), (45, 12)]),
                      iters=20), bf16)
    record("flash_fwd", "b2 h8 n64 d64 bf16 spans2 (row 1) LASER v ~ e^+-15",
           flash_case(torch, mods, 2, 8, 64, 64, bf16, spans_of(2, [(10, 30), (45, 12)]),
                      laser=True), bf16)
    record("flash_fwd", "b4 h8 n512 d64 bf16 spans2 (row 2) LASER v ~ e^+-15",
           flash_case(torch, mods, 4, 8, 512, 64, bf16, spans_of(4, [(10, 196), (300, 100)]),
                      laser=True), bf16)
    record("flash_fwd", "b2 h8 n1000 d64 bf16 q_off=0 kv_off=300 spans1 lse (masked rows)",
           flash_case(torch, mods, 2, 8, 1000, 64, bf16, spans_of(2, [(700, 196)]), q_offset=0,
                      kv_offset=300, lse=True), bf16)
    for dtype in (bf16, f32):
        record("flash_fwd", f"b2 h8 n1000 d256 {str(dtype).split('.')[-1]} spans1 lse",
               flash_case(torch, mods, 2, 8, 1000, 256, dtype, spans_of(2, [(33, 196)]),
                          lse=True, iters=3), dtype)

    lens4 = [8192, 5000, 1200, 37]
    for nq in (1, 196):
        for int8 in (False, True):
            record("decode_attn", f"b4 h8 nq{nq} cap8192 d64 bf16{' int8' if int8 else ''}",
                   decode_case(torch, mods, 4, 8, nq, 8192, 64, bf16, lens4, int8,
                               count=True), bf16)
    record("decode_attn", "b4 h8 nq196 cap8192 d64 f32",
           decode_case(torch, mods, 4, 8, 196, 8192, 64, f32, lens4, False, iters=3), f32)
    # every path of the split kernel at every head dim: row 1's lens leaves
    # whole chunks past it, row 2 has no valid slot (exactly 0)
    for d in (32, 128, 256):
        for dtype in (bf16, f32):
            for int8 in (False, True):
                for nq in (1, 196):
                    kind = f"{str(dtype).split('.')[-1]}{' int8' if int8 else ''}"
                    record("decode_attn", f"b3 h2 nq{nq} cap1000 d{d} {kind} lens 1000/37/0",
                           decode_case(torch, mods, 3, 2, nq, 1000, d, dtype, [1000, 37, 0], int8,
                                       iters=3), dtype)
    # long-context text serving (where the unsplit kernel lost to its plain
    # version 3.3x), with the flex_attention yardstick for bf16 and float32
    lens8 = [8192 - 37 * i for i in range(8)]
    for dtype, int8 in ((bf16, False), (bf16, True), (f32, False)):
        kind = f"{str(dtype).split('.')[-1]}{' int8' if int8 else ''}"
        record("decode_attn", f"long context: b8 h8 nq1 cap8192 d64 {kind}",
               decode_case(torch, mods, 8, 8, 1, 8192, 64, dtype, lens8, int8,
                           library=not int8, count=True), dtype)

    # the flash route past the first versions' limits: 200 spans a row,
    # b * h = 65536 + 16; the backward with logits near +-cap
    spans200 = [(3 + 5 * i, i % 5) for i in range(200)]
    for dtype in (bf16, f32):
        kind = str(dtype).split(".")[-1]
        record("flash_fwd", f"b2 h2 n1024 d64 {kind} spans200 lse",
               flash_case(torch, mods, 2, 2, 1024, 64, dtype, spans_of(2, spans200), lse=True,
                          iters=3), dtype)
        record("flash_bwd", f"b2 h2 n1024 d64 {kind} spans200",
               bwd_case(torch, mods, 2, 2, 1024, 64, dtype, spans_of(2, spans200), iters=3),
               dtype)
        record("flash_fwd", f"b4097 h16 n40 d32 {kind} spans1 (b*h 65552) lse",
               flash_case(torch, mods, 4097, 16, 40, 32, dtype, spans_of(4097, [(5, 10)]),
                          lse=True, iters=3), dtype)
        record("flash_bwd", f"b4097 h16 n40 d32 {kind} spans1 (b*h 65552)",
               bwd_case(torch, mods, 4097, 16, 40, 32, dtype, spans_of(4097, [(5, 10)]),
                        iters=3), dtype)
        record("flash_bwd", f"b2 h2 n300 d64 {kind} spans1 logits ~+-45 (cap 50)",
               bwd_case(torch, mods, 2, 2, 300, 64, dtype, spans_of(2, [(33, 196)]), iters=3,
                        near_cap=True), dtype)
        record("flash_bwd", f"b8 h8 n256 d64 {kind} spans1 row 0's dO . v_0 cancelling",
               bwd_case(torch, mods, 8, 8, 256, 64, dtype, spans_of(8, [(33, 196)]), iters=3,
                        cancel_row0=True), dtype)

    # training: the token-major route at the bench shape (the bench
    # packing's span at 40, length 196, and an empty one) and in float32
    for b, dtype in ((32, bf16), (4, f32)):
        fwd, bwd = nhd_case(torch, mods, b, 8, 256, 64, dtype, spans_of(b, [(40, 196), (0, 0)]))
        kind = str(dtype).split(".")[-1]
        record("flash_fwd_nhd", f"b{b} h8 n256 d64 {kind} rope spans2", fwd, dtype)
        record("flash_bwd_nhd", f"b{b} h8 n256 d64 {kind} rope spans2", bwd, dtype)
        # LASER's values at their extremes (the model's captures, phase 4e,
        # start near exp(0))
        fwd, bwd = nhd_case(torch, mods, b, 8, 256, 64, dtype, spans_of(b, [(40, 196), (0, 0)]),
                            laser=True)
        record("flash_fwd_nhd", f"b{b} h8 n256 d64 {kind} rope spans2 LASER v ~ e^+-15", fwd,
               dtype)
        record("flash_bwd_nhd", f"b{b} h8 n256 d64 {kind} rope spans2 LASER v ~ e^+-15", bwd,
               dtype)
    # the head-major backward: n 1024 training, row 7's envelope (no main
    # path reaches it, so its library yardstick is timed here), ring
    # attention's offsets with an lse cotangent, d 128, ragged n with whole
    # rows masked (kv_off > q_off: rows 0..299 see no key, so dq is exactly
    # 0 there, and kv rows no query reaches get dk = dv = 0), ragged n in
    # float32 (the FMA kernels), d 256 on both kernels
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
        ("b2 h8 n1000 d256 bf16 spans1", (2, 8, 1000, 256, bf16, spans_of(2, [(33, 196)])), {}),
        ("b2 h8 n1000 d256 f32 spans1", (2, 8, 1000, 256, f32, spans_of(2, [(33, 196)])), {}),
    ):
        record("flash_bwd", shape, bwd_case(torch, mods, *args, **kw), args[4])


# ---------------------------------------------------------------------------
# phase 3: small float32 model, card vs CPU
# ---------------------------------------------------------------------------


def items_err(a, b, what):
    """The largest latent difference of two sample item lists whose text
    items must be equal."""
    import numpy as np

    require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} items")
    err = 0.0
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            require(isinstance(y, tuple) and x[1].shape == y[1].shape, f"{what}: item kinds")
            err = max(err, float(np.abs(x[1] - y[1]).max()))
        else:
            require(np.array_equal(x, y), f"{what}: tokens {x} vs {y}")
    return err


def phase_reference(torch, Transfusion, mods):
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

    # the uncached loop (the flash kernel on every joint forward), the
    # batched one (flash prefill, decode ticks, the grouped ODE) and the
    # modality-only ODE (dense attention in both packages)
    kw = dict(kw, cache_kv=False)
    out_g, counts = counted(mods, lambda: gpu.sample(**kw))
    out_c = cpu.sample(**kw)
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] == 0,
            f"uncached sample: launches {counts}")
    unc_err = items_err(out_g, out_c, "uncached sample card vs cpu")
    prompts = [[np.asarray([3, 4, 5])], [np.asarray([6, gpu.som_ids[0]])],
               (0, np.random.default_rng(1).standard_normal((4, 4, 8)).astype(np.float32))]
    bkw = dict(max_length=20, modality_steps=4, init_modality_noise=noise, cfg_scale=3.0,
               text_temperature=0.0)
    outs_g, b_counts = counted(mods, lambda: gpu.sample_batch(prompts, **bkw))
    require(b_counts["flash_fwd"] > 0 and b_counts["decode_attn"] > 0,
            f"sample_batch: launches {b_counts}")
    outs_c = cpu.sample_batch(prompts, **bkw)
    batch_err = max(items_err(g, c, f"sample_batch request {i} card vs cpu")
                    for i, (g, c) in enumerate(zip(outs_g, outs_c)))
    lat0 = noise.reshape(1, 4, 4, 8)
    gen_err = (gpu.generate_modality_only(noise=lat0, modality_steps=4).cpu()
               - cpu.generate_modality_only(noise=lat0, modality_steps=4)).abs().max().item()
    require(max(unc_err, batch_err, gen_err) <= 1e-3,
            f"card vs cpu: uncached {unc_err}, sample_batch {batch_err}, modality-only {gen_err}")
    eng_err, e_counts = engines_reference(torch, mods, gpu, cpu, noise)
    log(json.dumps({"reference": "small f32 model, card vs cpu", "tokens_equal": True,
                    "prefill_logits_err": err, "latents_err": lat_err,
                    "uncached_sample_latents_err": unc_err,
                    "sample_batch_latents_err": batch_err,
                    "generate_modality_only_err": gen_err, "engine_mm_latents_err": eng_err,
                    "launches": {"uncached sample": counts, "sample_batch": b_counts,
                                 **e_counts}}))


def engines_reference(torch, mods, gpu, cpu, noise):
    """Both engines on the card against the CPU: the text engine over 5
    requests in 2 rows, the first filling its 128-slot row exactly (prompt
    100 + 28 new; tokens equal); the multimodal engine (CFG 3.0, 2 slots, 4
    requests) through a capacity rebuild (a 126-token [som] prompt in a
    128-slot pool; tokens equal, latents within 1e-3). Returns (latent err,
    launches)."""
    import numpy as np

    ServingEngine = mods["engine"].ServingEngine
    MultimodalServingEngine = mods["engine_mm"].MultimodalServingEngine
    rng = np.random.default_rng(5)
    prompts = [[gpu.sos_id] + rng.integers(0, 16, 99).tolist(), [gpu.sos_id, 3, 4],
               [gpu.sos_id, 5], [gpu.sos_id, 6, 1], [gpu.sos_id, 2]]
    budgets = [28, 40, 9, 7, 12]

    def text(m):
        eng = ServingEngine(m, max_batch=2, max_seq_len=128, decode_chunk=16, temperature=0.0)
        require(eng.cap == 128, "engine reference: capacity")
        for p, b in zip(prompts, budgets):
            eng.submit(np.asarray(p, np.int32), b)
        return {r.rid: r.tokens for r in eng.run()}

    got, t_counts = counted(mods, lambda: text(gpu))
    require(got == text(cpu), "text engine: tokens card vs cpu")
    require(t_counts["flash_fwd"] > 0 and t_counts["decode_attn"] > 0,
            f"text engine: launches {t_counts}")

    mm_prompts = [[np.asarray([3] * 123 + [1, gpu.som_ids[0]], np.int32)],
                  [np.asarray([3, 4, 5])], [np.asarray([6, gpu.som_ids[0]])],
                  (0, np.random.default_rng(1).standard_normal((4, 4, 8)).astype(np.float32))]

    def mm(m):
        eng = MultimodalServingEngine(m, max_requests=2, max_seq_len=1, cfg_scale=3.0,
                                      modality_steps=4, text_temperature=0.0,
                                      init_modality_noise=noise)
        for p in mm_prompts:
            eng.submit(p, max_length=20)
        out = {f.rid: f.output for f in eng.run()}
        require(eng.stats["rebuilds"] >= 1, "multimodal engine: the rebuild path never ran")
        return out

    outs_g, m_counts = counted(mods, lambda: mm(gpu))
    outs_c = mm(cpu)
    require(m_counts["flash_fwd"] > 0 and m_counts["decode_attn"] > 0,
            f"multimodal engine: launches {m_counts}")
    err = max(items_err(outs_g[r], outs_c[r], f"multimodal engine request {r} card vs cpu")
              for r in outs_c)
    require(err <= 1e-3, f"multimodal engine: latents card vs cpu {err}")
    return err, {"text engine": t_counts, "multimodal engine": m_counts}


def image_model(torch, Transfusion, mods, device, dtype, cfg, seed):
    """`cfg` with a patch encoder / decoder and U-Net halves (SAME conv and
    transposed conv, stride 2) from `models/modality_io.py`; the halves'
    weights drawn under `seed`."""
    mio = mods["modality_io"]
    dim, d_lat = cfg["transformer"]["dim"], cfg["dim_latent"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        unet = (mio.SameConv2d(d_lat, dim), mio.SameConvTranspose2d(dim, d_lat))
    return Transfusion(device=device, dtype=dtype, seed=seed, modality_encoder=mio.PatchEncoder(),
                       modality_decoder=mio.PatchDecoder(), pre_post_transformer_enc_dec=unet,
                       **IMAGE_OPTS, **cfg)


def image_reference(torch, Transfusion, Trainer, mods):
    """The small float32 image model (patch codec, U-Net halves, pos-emb,
    reconstruction and velocity terms) on the card against the CPU: one
    step's loss, its velocity and reconstruction parts and every gradient
    within 1e-4; cached `sample` (CFG 3.0) latents and decoded images
    within 1e-3, tokens equal."""
    import numpy as np

    LossDraws = mods["transfusion"].LossDraws
    cfg = dict(SMALL_CFG, modality_default_shape=(4, 4))
    gpu = image_model(torch, Transfusion, mods, "cuda", torch.float32, cfg, 5)
    cpu = image_model(torch, Transfusion, mods, "cpu", torch.float32, cfg, 5)
    cpu.core.load_state_dict({k: v.cpu() for k, v in gpu.core.state_dict().items()})
    rng = np.random.default_rng(2)
    batch = [[rng.integers(0, 16, 5).astype(np.int32),
              (0, rng.uniform(size=(8, 8, 2)).astype(np.float32)),
              rng.integers(0, 16, 3).astype(np.int32)] for _ in range(4)]
    packed = cpu.pack(cpu.encode_modalities(batch), shift_friendly=True)
    # times 0.3-0.6: near t = 1 the x-prediction's 1 / (1 - t) scales the
    # losses by up to 100, and float32 rounding alone with them
    times = torch.linspace(0.3, 0.6, 4)[:, None].expand(4, packed.spans.shape[1])
    draws = cpu.make_draws(packed.to_torch("cpu"), torch.Generator().manual_seed(0),
                           times=times, velocity=True)
    out = {}
    for side, m in (("cuda", gpu), ("cpu", cpu)):
        dev = m.device
        d = LossDraws(times=draws.times.to(dev), cfg_uniform=draws.cfg_uniform.to(dev),
                      noises=tuple(t.to(dev) for t in draws.noises),
                      ema_noises=tuple(t.to(dev) for t in draws.ema_noises))
        params = Trainer(m).init_state().params
        leaves = {k: t.requires_grad_(True) for k, t in params.items()}
        ema = {k: t.detach() + 0.01 for k, t in params.items()}

        def step(m=m, d=d, leaves=leaves, ema=ema, dev=dev):
            loss, bd = m._loss_impl(leaves, packed.to_torch(dev), d, m.prob_uncond,
                                    ema_params=ema)
            return ([loss.item(), bd.velocity[0].item(), bd.recon[0].item()],
                    torch.autograd.grad(loss, list(leaves.values())))

        (losses, grads), counts = counted(mods, step)
        out[side] = (losses, [g.cpu() for g in grads], counts)
    loss_err = max(abs(a - b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    grad_err = max((a - b).abs().max().item() for a, b in zip(out["cuda"][1], out["cpu"][1]))
    counts = out["cuda"][2]
    require(counts["flash_fwd"] + counts["flash_fwd_nhd"] > 0
            and counts["flash_bwd"] + counts["flash_bwd_nhd"] > 0,
            f"image model step: kernel launches {counts}")
    require(loss_err <= 1e-4 and grad_err <= 1e-4,
            f"image model step: loss/velocity/recon err {loss_err}, grad err {grad_err}")

    noise = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([3, gpu.som_ids[0]])], max_length=12, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0, cache_kv=True)
    errs = {}
    for raw in (True, False):
        got, s_counts = counted(mods, lambda: gpu.sample(return_unprocessed_modalities=raw, **kw))
        want = cpu.sample(return_unprocessed_modalities=raw, **kw)
        shapes = [o[1].shape for o in got if isinstance(o, tuple)]
        require(shapes and all(s_ == ((4, 4, 8) if raw else (8, 8, 2)) for s_ in shapes),
                f"image model sample: shapes {shapes}")
        errs["latents" if raw else "decoded"] = items_err(got, want, "image model sample")
    require(s_counts["decode_attn"] > 0, f"image model sample: launches {s_counts}")
    require(max(errs.values()) <= 1e-3, f"image model sample card vs cpu: {errs}")
    log(json.dumps({"reference": "small f32 image model (encoder, U-Net, pos-emb, velocity "
                    "and recon), card vs cpu", "losses": out["cpu"][0],
                    "loss_parts_err": loss_err, "max_grad_err": grad_err,
                    "sample_err": errs, "launches": {"step": counts, "sample": s_counts}}))


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
    image_reference(torch, Transfusion, Trainer, mods)
    laser_reference(torch, Transfusion, Trainer, mods)


# the recipes' transformer options (examples/train_text_only.py:27-37,
# train_image_only.py:51-57): LASER, 4 residual streams of 4 fracs, and the
# fused projections
RECIPE_OPTS = dict(attn_laser=True, num_residual_streams=4, num_residual_fracs=4)
# Muon's Newton-Schulz runs in bf16 and amplifies rounding along a
# gradient's small singular directions (3.4445x an iteration): a Muon
# matrix's step on the card is held within this share of the CPU step's
# Frobenius norm; Adam-atan2 entries within 1e-5 but those whose ~0
# gradient takes its sign from rounding (at most 0.1 %, each within 4 lr)
MUON_REL_TOL = 0.5


def hold_new_params(torch, got, want, before, muon, lr):
    """The card's parameters after one step against the CPU's (see
    MUON_REL_TOL). Returns (largest Muon share, Adam entries past 1e-5)."""
    worst, flips, total = 0.0, 0, 0
    for k, w in want.items():
        diff = got[k] - w
        if k in muon:
            share = diff.norm().item() / max((w - before[k]).norm().item(), 1e-30)
            worst = max(worst, share)
        else:
            require(diff.abs().max().item() <= 4 * lr, f"{k}: new params card vs cpu")
            flips += int((diff.abs() > 1e-5).sum())
            total += diff.numel()
    require(worst <= MUON_REL_TOL and flips <= 1e-3 * total,
            f"new params card vs cpu: Muon share {worst}, {flips} of {total} Adam entries")
    return worst, flips


def laser_reference(torch, Transfusion, Trainer, mods):
    """A small float32 model with the recipes' options and fused projections
    (token-major route) on the card against the CPU: one
    `Trainer(optimizer=muon_adam_atan2(...))` step's loss and every gradient
    within 1e-4, its new parameters as `hold_new_params` says; cached
    `sample` (CFG 3.0) tokens equal, latents within 1e-3, no decode launch."""
    import numpy as np

    from transfusion_tpu_torch.training import muon_adam_atan2

    LossDraws = mods["transfusion"].LossDraws
    cfg = dict(SMALL_NHD_CFG, transformer=dict(SMALL_NHD_CFG["transformer"], **RECIPE_OPTS,
                                               fuse_projections=True))
    gpu = Transfusion(device="cuda", dtype=torch.float32, seed=6, **cfg)
    cpu = Transfusion(device="cpu", dtype=torch.float32, seed=6, **cfg)
    cpu.core.load_state_dict({k: v.cpu() for k, v in gpu.core.state_dict().items()})
    rng = np.random.default_rng(3)
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
        trainer = Trainer(m, optimizer=muon_adam_atan2(muon_lr=3e-4, adam_lr=3e-4))
        state = trainer.init_state()

        def step(trainer=trainer, state=state, d=d, dev=dev):
            loss, _, grads = trainer._grads(state, packed.to_torch(dev), d)
            new, _ = trainer._apply(state, grads, loss, {}, 0)
            return loss.item(), grads, new.params

        (loss, grads, new), counts = counted(mods, step)
        out[dev.type] = (loss, {k: g.cpu() for k, g in grads.items()},
                         {k: p.cpu() for k, p in new.items()},
                         {k: p.cpu() for k, p in state.params.items()}, counts)
    loss_err = abs(out["cuda"][0] - out["cpu"][0])
    grad_err = max((out["cuda"][1][k] - g).abs().max().item() for k, g in out["cpu"][1].items())
    counts = out["cuda"][4]
    require(counts["flash_fwd_nhd"] > 0 and counts["flash_bwd_nhd"] > 0,
            f"LASER reference step: kernel launches {counts}")
    require(loss_err <= 1e-4 and grad_err <= 1e-4,
            f"LASER reference step: loss err {loss_err}, grad err {grad_err}")
    muon_share, flips = hold_new_params(torch, out["cuda"][2], out["cpu"][2], out["cpu"][3],
                                        set(cpu.muon_parameters()), 3e-4)

    noise = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([3, gpu.som_ids[0]])], max_length=20, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0, cache_kv=True)
    got, s_counts = counted(mods, lambda: gpu.sample(**kw))
    lat_err = items_err(got, cpu.sample(**kw), "LASER model sample card vs cpu")
    require(s_counts["flash_fwd"] > 0 and s_counts["decode_attn"] == 0,
            f"LASER model sample: launches {s_counts}")
    require(lat_err <= 1e-3, f"LASER model sample card vs cpu: latents {lat_err}")
    log(json.dumps({"reference": "small f32 LASER + 4-stream + fused model, Muon step, "
                    "card vs cpu", "loss": out["cpu"][0], "loss_err": loss_err,
                    "max_grad_err": grad_err, "muon_step_share": muon_share,
                    "adam_entries_past_1e-5": flips, "sample_latents_err": lat_err,
                    "launches": {"step": counts, "sample": s_counts}}))


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
    with replayed_launches(mods):
        out = fn()
    torch.cuda.synchronize()
    counts = {name: fn_.launches for name, fn_ in counters.items()}
    for name, (wrapper, row) in BY_ROW.items():
        counts[name] = counters[wrapper].launches_by_row[row]
    return out, counts


@contextlib.contextmanager
def replayed_launches(mods):
    """While open, the decode kernel's launch counter counts what the card
    runs of a text engine's `DecodeGraph`: the step its capture records
    (recorded, not run) is taken off, and each replay adds it back. Open it
    inside a `chunk_watch` of `DecodeGraph.chunk`, which counts replays on
    its own."""
    cls, decode = mods["engine"].DecodeGraph, mods["counters"]["decode_attn"]
    capture, chunk = cls.capture, cls.chunk

    def spy_capture(graph):
        capture(graph)
        decode.launches -= graph.decode_launches

    def spy_chunk(graph, *args, **kw):
        replays = graph.replays
        out = chunk(graph, *args, **kw)
        decode.launches += (graph.replays - replays) * graph.decode_launches
        return out

    cls.capture, cls.chunk = spy_capture, spy_chunk
    try:
        yield
    finally:
        cls.capture, cls.chunk = capture, chunk


# kernel name -> the wrapper that `models/layers.py` calls
SPIED = {"flash_fwd": "flash_attention", "decode_attn": "decode_attention",
         "flash_fwd_nhd": "flash_attention_nhd"}


@contextlib.contextmanager
def capturing(torch, mods, want):
    """While open, keep a copy of the arguments of the first call the model
    makes to each wrapper named in `want` (as `models/layers.py` binds it)
    that want[key] accepts, and, when its output takes part in a backward
    pass, the output's cotangent as 'do'. A key is a kernel name, or
    'name:tag' for a further capture of the same wrapper. The call itself
    goes on to the wrapper unchanged."""
    layers, seen, wanted = mods["layers"], {}, {}
    for key, accept in want.items():
        wanted.setdefault(SPIED[key.split(":")[0]], []).append((key, accept))
    originals = {attr: getattr(layers, attr) for attr in wanted}
    for attr, keys in wanted.items():
        orig = originals[attr]

        def spy(*args, _orig=orig, _sig=inspect.signature(orig), _keys=keys, **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            first = [key for key, accept in _keys if key not in seen and accept(bound.arguments)]
            for key in first:
                seen[key] = {k: x.detach().clone() if isinstance(x, torch.Tensor) else x
                             for k, x in bound.arguments.items()}
            out = _orig(*args, **kw)
            if first and isinstance(out, torch.Tensor) and out.requires_grad:
                def keep(g, _first=first):
                    for key in _first:
                        seen[key]["do"] = g.detach().clone()
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


def check_main_path(torch, mods, name, calls, dtype, library=False, block_q=None):
    """Hold each kernel against its plain version (the forward's computed
    block_q query rows at a time) on the tensors the main path gave it
    (captured from one call of the serving run); count the decode call's
    kernels; with `library`, time the flex_attention yardsticks too."""
    require(set(calls) == {"flash_fwd", "decode_attn"}, f"{name}: captured only {sorted(calls)}")
    out = {}
    fa, dc = calls["flash_fwd"], calls["decode_attn"]
    qs = shape_str
    kv = "int8" if dc["k_scale"] is not None else str(dc["k"].dtype).split(".")[-1]
    prefix = "prefix" if bias_is_prefix(dc["bias"]) else "non-prefix"
    out["decode_attn"] = record("decode_attn", f"main path, {name}: q {qs(dc['q'])} "
                                f"cache {qs(dc['k'])} {kv}, {prefix} bias, "
                                f"lens {dc['lens'].tolist()}",
                                check_decode(torch, mods, dc, library=library, count=True), dtype)
    out["flash_fwd"] = record("flash_fwd", f"main path, {name}: prefill q {qs(fa['q'])} "
                              f"spans {'none' if fa['spans'] is None else qs(fa['spans'])}",
                              check_flash(torch, mods, fa, library=library, block_q=block_q),
                              dtype)
    return out


def serve_text(torch, mods, model, name, prompts, new, quant, cap, vocab, library=False,
               block_q=None):
    """One `generate_text_batch` path: a warm-up run that also captures one
    prefill and one decode call (each held against its plain version; its
    cache has the timed run's capacity `cap`), the prefill alone, then `new`
    tokens with the launch counters set to 0. Returns (report, launches,
    main-path results)."""
    b = len(prompts)
    run = lambda k: model.generate_text_batch(  # noqa: E731
        prompts, max_new_tokens=k, temperature=0.0, kv_quantize=quant)
    with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                 "decode_attn": lambda a: True}) as calls:
        run(2)
    torch.cuda.synchronize()
    require(calls["decode_attn"]["k"].shape[2] == cap, f"{name}: warm-up cache capacity")
    main = check_main_path(torch, mods, name, calls, torch.bfloat16, library=library,
                           block_q=block_q)
    del calls
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, counts = counted(mods, lambda: run(new))
    t_all = time.perf_counter() - t0
    toks = toks.cpu()
    require(tuple(toks.shape) == (b, new), f"{name}: tokens shape {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < vocab)).all()), f"{name}: non-text token")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0,
            f"{name}: kernel launches {counts}")
    report = dict(
        seconds=t_all, tokens_per_s=b * new / t_all,
        ms_per_decode_step=(t_all - t_prefill) / (new - 1) * 1e3,
        prefill_plus_one_step_ms=t_prefill * 1e3, launches=counts,
    )
    log(json.dumps({"serving": name, **report}))
    return report, counts, main


def phase_serving(torch, Transfusion, mods):
    """Each path: a warm-up run that also captures one call of each kernel
    (checked against the plain version at those tensors), then the counted,
    timed run. Returns (launch totals, main-path kernel results)."""
    import numpy as np

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in serving_lengths()]
    new = 128
    totals = dict.fromkeys(KERNELS, 0)
    report, main = {}, {}

    for name, quant in (("generate_text_batch bf16 KV", False),
                        ("generate_text_batch int8 KV", True)):
        # the width 1024 plus 2 or 128 new tokens both round up to 1152
        report[name], counts, main[name] = serve_text(
            torch, mods, model, name, prompts, new, quant, 1152, 256, library=not quant)
        for k in totals:
            totals[k] += counts[k]

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
    del model
    torch.cuda.empty_cache()

    # long prompts on the 573M config: where the split of the cache shows
    # (the unsplit kernel ran 128 blocks, each streaming ~8k slots alone)
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **LONG_CFG)
    prompts = [rng.integers(0, LONG_CFG["num_text_tokens"], size=n) for n in LONG_PROMPTS]
    for quant in (False, True):
        name = f"573M long prompts generate_text_batch {'int8' if quant else 'bf16'} KV"
        # width 8192 plus 2 or LONG_NEW new tokens both round up to 8320
        report[name], counts, main[name] = serve_text(
            torch, mods, model, name, prompts, LONG_NEW, quant, 8320,
            LONG_CFG["num_text_tokens"], block_q=LONG_BLOCK_Q)
        for k in totals:
            totals[k] += counts[k]
    del model
    torch.cuda.empty_cache()
    return totals, main


# ---------------------------------------------------------------------------
# phase 4b: uncached and batched sampling at full width
# ---------------------------------------------------------------------------

# sample_batch's requests: four prompts of text ending in [som], four of
# plain text
BATCH_IMAGE_TEXT = [24, 81, 143, 200]
BATCH_TEXT = [16, 311, 605, 900]
BF16_CONTRACT = dict(atol=0.15, rtol=0.05)  # tests/test_sample_batch.py:233-280


def bf16_agreement(got, want, what):
    """(token agreement over the common prefix of each pair of text items,
    the first sampled position where they differ, largest latent error as a
    share of the bf16 limit) of two item lists, item by item while their
    kinds agree. Latents of equal shape must hold atol 0.15 + rtol 0.05."""
    import numpy as np

    agree, first, worst = [], None, 0.0
    seen = 0
    for g, w in zip(got, want):
        if isinstance(g, tuple) != isinstance(w, tuple):
            break
        if isinstance(g, tuple):
            if g[1].shape == w[1].shape:
                excess = np.abs(g[1] - w[1]) / (BF16_CONTRACT["atol"]
                                                + BF16_CONTRACT["rtol"] * np.abs(w[1]))
                worst = max(worst, float(excess.max()))
        else:
            n = min(len(g), len(w))
            if n:
                eq = np.asarray(g[:n]) == np.asarray(w[:n])
                agree.append(float(eq.mean()))
                if first is None and not eq.all():
                    first = seen + int(np.argmin(eq))
            seen += len(g)
    require(worst <= 1.0, f"{what}: latents outside the bf16 contract ({worst:.3f} of it)")
    return agree, first, worst


def text_len(items):
    return sum(len(it) for it in items if not isinstance(it, tuple))


def forced_agreement(torch, model, items, sampled, text_only=False):
    """The share of the last `sampled` text tokens of `items` that equal the
    greedy choice (argmax over the vocabulary, as the samplers take it; over
    the text ids with `text_only`, as the text engine takes it) of one
    uncached joint forward of the same history, past modalities clean.
    Each position is judged on the same history, so one flipped token does
    not count against every token after it."""
    packed = model.pack([items], wrap_sos_eos=False, add_meta=False).to_torch(model.device)
    times = torch.ones((1, packed.spans.shape[1]), device=model.device)
    logits = model.core.joint(packed, times)[0][0].float()
    if text_only:
        logits = logits[:, : model.num_text_tokens]
    pos = torch.nonzero(packed.text[0] >= 0)[:, 0][-sampled:]
    return (logits[pos - 1].argmax(-1) == packed.text[0, pos]).float().mean().item()


@contextlib.contextmanager
def chunk_watch(torch, mods, host=None, attr="_chunk_tick_impl"):
    """While open, time and count the text chunks (`host`'s `attr`:
    sample_batch's `_chunk_tick_impl` by default, or the text engine's
    `DecodeGraph.chunk`, whose replays count the decode launches its capture
    recorded): each runs with CUDA's sync debug mode at 'error' (a
    synchronising call inside a chunk raises), and the host fetches made
    right after it are counted."""
    sb = mods["sample_batch"]
    host = sb if host is None else host
    graph_cls = mods["engine"].DecodeGraph
    decode = mods["counters"]["decode_attn"]
    chunk, fetch = getattr(host, attr), sb._fetch
    stats = dict(chunks=0, ticks=0, fetches_after_chunk=0, chunk_seconds=0.0,
                 decode_launches=0, fetches=0)
    last = {"t0": None}

    def spy_chunk(*args, **kw):
        t0 = time.perf_counter()
        graph = args[0] if isinstance(args[0], graph_cls) else None
        before = decode.launches, graph.replays if graph is not None else 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = chunk(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stats["chunks"] += 1
        stats["ticks"] += kw["k"]
        stats["decode_launches"] += decode.launches - before[0]
        if graph is not None:
            stats["decode_launches"] += (graph.replays - before[1]) * graph.decode_launches
        last["t0"] = t0
        return out

    def spy_fetch(t):
        out = fetch(t)
        stats["fetches"] += 1
        if last["t0"] is not None:  # the chunk's own fetch ends its time
            stats["fetches_after_chunk"] += 1
            stats["chunk_seconds"] += time.perf_counter() - last["t0"]
            last["t0"] = None
        return out

    setattr(host, attr, spy_chunk)
    sb._fetch = spy_fetch
    try:
        yield stats
    finally:
        setattr(host, attr, chunk)
        sb._fetch = fetch


def phase_sampling(torch, Transfusion, mods):
    """The bench model through uncached `sample()`, `sample_batch` (R 8, 16
    pool rows), `generate_modality_only` and the adaptive ODE, each kernel
    held against its plain version on a call captured from its path.
    Returns the launch totals."""
    import numpy as np

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((196, 32)).astype(np.float32)
    totals = dict.fromkeys(KERNELS, 0)

    # uncached sample(): every text step and flow evaluation re-forwards the
    # bucket-packed sequence through the flash kernel
    name = "sample uncached cfg 3.0"
    prompt = [np.asarray(list(rng.integers(0, 256, 24)) + [model.som_ids[0]], np.int32)]
    kw = dict(prompt=prompt, max_length=196 + 16, text_temperature=0.0, cfg_scale=3.0,
              modality_steps=16, fixed_modality_shape=(14, 14), init_modality_noise=noise)
    with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                 "flash_fwd_nhd": lambda a: True}) as calls:
        model.sample(**{**kw, "modality_steps": 2, "max_length": 197})
    torch.cuda.synchronize()
    require(calls, f"{name}: no flash call captured")
    if "flash_fwd_nhd" in calls:
        a = calls["flash_fwd_nhd"]
        route = 5
        record("flash_fwd_nhd", f"main path, {name}: q {shape_str(a['q'])} rope spans "
               f"{shape_str(a['spans'])} (row 5)", check_nhd(torch, mods, a)[0], torch.bfloat16)
    else:
        a = calls["flash_fwd"]
        b, h, nq, d = a["q"].shape
        route = mods["flash"].tpu_row(h, nq, a["k"].shape[2], d, bwd=False)
        record("flash_fwd", f"main path, {name}: q {shape_str(a['q'])} (row {route})",
               check_flash(torch, mods, a), torch.bfloat16)
    del calls
    t0 = time.perf_counter()
    items, counts = counted(mods, lambda: model.sample(**kw))
    dt = time.perf_counter() - t0
    require(counts["flash_fwd"] + counts["flash_fwd_nhd"] > 0 and counts["decode_attn"] == 0,
            f"{name}: launches {counts}")
    lats = [it[1] for it in items if isinstance(it, tuple)]
    require(len(lats) == 1 and lats[0].shape == (14, 14, 32) and np.isfinite(lats[0]).all(),
            f"{name}: latents")
    cached = model.sample(cache_kv=True, kv_quantize=False, **kw)
    agree, first, worst = bf16_agreement(items, cached, f"{name} vs cache_kv")
    for k in totals:
        totals[k] += counts[k]
    log(json.dumps({"sampling": name, "seconds": dt, "s_per_image": dt, "flash_route_row": route,
                    "latents_vs_cached_of_bf16_limit": worst,
                    "token_agreement_vs_cached": agree, "first_differing_token": first,
                    "launches": counts}))

    # sample_batch: R 8 requests, 2R = 16 pool rows
    name = "sample_batch R 8 cfg 3.0"
    prompts = ([[np.asarray(list(rng.integers(0, 256, n)) + [model.som_ids[0]], np.int32)]
                for n in BATCH_IMAGE_TEXT]
               + [[rng.integers(0, 256, n).astype(np.int32)] for n in BATCH_TEXT])
    bkw = dict(max_length=196 + 32, text_chunk=32, text_temperature=0.0, cfg_scale=3.0,
               modality_steps=16, fixed_modality_shape=(14, 14), init_modality_noise=noise,
               kv_quantize=False)
    rows = 2 * len(prompts)
    with capturing(torch, mods, {
            "decode_attn:nq1": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (rows, 1),
            "decode_attn:nq196": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (rows, 196),
    }) as calls:
        model.sample_batch(prompts, **{**bkw, "modality_steps": 2, "max_length": 198})
    torch.cuda.synchronize()
    require(set(calls) == {"decode_attn:nq1", "decode_attn:nq196"},
            f"{name}: captured only {sorted(calls)}")
    for key, a in calls.items():
        valid = a["bias"] > -1e29
        below = torch.arange(valid.shape[1], device="cuda")[None, :] < a["lens"][:, None]
        holes = int((below & ~valid).any(1).sum())
        record(
            "decode_attn", f"main path, {name}: q {shape_str(a['q'])} cache {shape_str(a['k'])}, "
            f"{holes} of {rows} rows with invalid slots below lens, lens {a['lens'].tolist()}",
            check_decode(torch, mods, a, count=True), torch.bfloat16)
    del calls
    t0 = time.perf_counter()
    with chunk_watch(torch, mods) as stats:
        outs, counts = counted(mods, lambda: model.sample_batch(prompts, **bkw))
    dt = time.perf_counter() - t0
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0, f"{name}: launches {counts}")
    require(stats["chunks"] > 0 and stats["fetches_after_chunk"] == stats["chunks"],
            f"{name}: chunk fetches {stats}")
    images = sum(isinstance(o, tuple) for out in outs for o in out)
    # each request against its solo sample(cache_kv=True): latents within the
    # bf16 limits, and the sampled tokens of both judged position by position
    # against a forward of their own history (in bf16 about one greedy
    # choice in 50-100 is a near-tie that rounding flips, for any path; the
    # rest of a continuation then differs, so agreement over the common
    # prefix of a 228-token continuation measures where the first flip fell)
    forced, forced_solo, prefix, firsts, worst = [], [], [], [], 0.0
    t_solo = time.perf_counter()
    solo_kw = {k: v for k, v in bkw.items() if k != "text_chunk"}
    for p, got in zip(prompts, outs):
        solo = model.sample(p, cache_kv=True, **solo_kw)
        a_, f_, w_ = bf16_agreement(got, solo, f"{name}: a request vs its solo sample")
        prefix += a_
        firsts.append(f_)
        worst = max(worst, w_)
        start = model._prompt_to_items(p)
        new_images = sum(isinstance(o, tuple) for o in got) - sum(
            isinstance(o, tuple) for o in start)
        for items, out in ((got, forced), (solo, forced_solo)):
            # sampled tokens: the text past the prompt, less one eom an image
            sampled = text_len(items) - text_len(start) - new_images
            if sampled > 0:
                out.append(forced_agreement(torch, model, items, sampled))
    t_solo = time.perf_counter() - t_solo
    require(forced and float(np.mean(forced)) >= 0.95,
            f"{name}: per-position token agreement {forced} (solo's own: {forced_solo})")
    for k in totals:
        totals[k] += counts[k]
    log(json.dumps({
        "sampling": name, "seconds": dt, "requests_per_s": len(prompts) / dt,
        "images": images, "s_per_image": dt / max(images, 1),
        "ms_per_text_tick": stats["chunk_seconds"] / stats["ticks"] * 1e3,
        "decode_launches_per_tick": stats["decode_launches"] / stats["ticks"],
        "host_fetches_per_chunk": stats["fetches_after_chunk"] / stats["chunks"],
        "chunks": stats["chunks"], "ticks": stats["ticks"], "host_fetches": stats["fetches"],
        "token_agreement_per_position": float(np.mean(forced)),
        "solo_token_agreement_per_position": float(np.mean(forced_solo)),
        "token_agreement_over_common_prefix_vs_solo": prefix,
        "first_differing_token_vs_solo": firsts,
        "latents_vs_solo_of_bf16_limit": worst, "solo_seconds": t_solo, "launches": counts}))

    # generate_modality_only: dense attention in both packages (no kernel)
    t0 = time.perf_counter()
    lat = model.generate_modality_only(batch_size=8, fixed_modality_shape=(14, 14),
                                       generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    require(tuple(lat.shape) == (8, 14, 14, 32) and bool(torch.isfinite(lat).all()),
            "generate_modality_only: latents")
    log(json.dumps({"sampling": "generate_modality_only b8 14x14",
                    "seconds": time.perf_counter() - t0}))

    del model
    torch.cuda.empty_cache()

    # the adaptive ODE, per row, through sample_batch's grouped ODE, on the
    # same weights in float32: in bf16 the flow's rounding sits above the
    # 1e-5 tolerance and the controller took ~3000 Heun iterations (~100 s)
    name = "sample_batch R 2 adaptive ODE, float32"
    model = Transfusion(device="cuda", dtype=torch.float32, seed=0, odeint_method="adaptive",
                        **BENCH_CFG)
    sb = mods["sample_batch"]
    rows_solver, evals = sb.odeint_adaptive_rows, [0]

    def counting_solver(fn, y0, *a, **k):
        def f(t, y):
            evals[0] += 1
            return fn(t, y)
        return rows_solver(f, y0, *a, **k)

    sb.odeint_adaptive_rows = counting_solver
    try:
        t0 = time.perf_counter()
        outs, counts = counted(mods, lambda: model.sample_batch(prompts[:2], **{
            **bkw, "max_length": 197}))
        dt = time.perf_counter() - t0
    finally:
        sb.odeint_adaptive_rows = rows_solver
    lats = [o[1] for out in outs for o in out if isinstance(o, tuple)]
    require(len(lats) == 2 and all(np.isfinite(x).all() for x in lats), f"{name}: latents")
    for k in totals:
        totals[k] += counts[k]
    # fewer than max_steps (4096) iterations: t reached 1 by accepted steps,
    # not by the closing Euler step
    require(evals[0] // 2 < 4096, f"{name}: {evals[0] // 2} iterations ran out of steps")
    log(json.dumps({"sampling": name, "seconds": dt, "flow_evaluations": evals[0],
                    "heun_iterations": evals[0] // 2, "launches": counts}))
    del model
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 4c: the continuous-batching engines at full width
# ---------------------------------------------------------------------------

# the text engine's queue: a chat server's, where most answers are short
ENGINE_REQUESTS = 24
ENGINE_SHORT, ENGINE_LONG = (16, 64), (128, 256)  # budgets of 16 and of 8 requests


def engine_text_workload(rng):
    """24 seeded ragged prompts of 16-900 tokens; 16 budgets of 16-64 new
    tokens and 8 of 128-256, shuffled."""
    import numpy as np

    lengths = rng.permutation(np.linspace(16, 900, ENGINE_REQUESTS).astype(int))
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32) for n in lengths]
    budgets = np.concatenate([rng.integers(ENGINE_SHORT[0], ENGINE_SHORT[1] + 1, 16),
                              rng.integers(ENGINE_LONG[0], ENGINE_LONG[1] + 1, 8)])
    return prompts, [int(b) for b in rng.permutation(budgets)]


def hold_captured(torch, mods, name, calls, want):
    """Hold each captured call of `want` against its plain version (the
    phase-2 tolerances); the flash call's TPU kernel-table row logged."""
    require(set(calls) == set(want), f"{name}: captured only {sorted(calls)} of {sorted(want)}")
    rows = {}
    for key, a in calls.items():
        kernel = key.split(":")[0]
        if kernel == "flash_fwd":
            b, h, nq, d = a["q"].shape
            rows[key] = mods["flash"].tpu_row(h, nq, a["k"].shape[2], d, bwd=False)
            record("flash_fwd", f"main path, {name}: prefill q {shape_str(a['q'])} "
                   f"(row {rows[key]})", check_flash(torch, mods, a), torch.bfloat16)
        else:
            record("decode_attn", f"main path, {name}: q {shape_str(a['q'])} cache "
                   f"{shape_str(a['k'])}, lens {a['lens'].tolist()}",
                   check_decode(torch, mods, a, count=True), torch.bfloat16)
    return rows


def watch_report(stats, seconds):
    return {"chunks": stats["chunks"], "ticks": stats["ticks"],
            "ms_per_chunk": stats["chunk_seconds"] / stats["chunks"] * 1e3,
            "ms_per_tick": stats["chunk_seconds"] / stats["ticks"] * 1e3,
            "decode_launches_per_tick": stats["decode_launches"] / stats["ticks"],
            "host_fetches_per_chunk": stats["fetches_after_chunk"] / stats["chunks"],
            "chunk_share_of_run": stats["chunk_seconds"] / seconds}


def phase_engines(torch, Transfusion, mods):
    """The bench model through both continuous-batching engines: the text
    engine (8 rows, chunks up to 64, greedy) over a chat server's queue of
    24 requests (warmup, run, then serve on the same workload), and the
    multimodal engine (4 requests, 8 pool rows, CFG 3.0, 16 midpoint steps,
    14x14, chunks up to 32) over phase 4b's 8-request mix (warmup, run).
    Each engine's first admission prefill and its decode calls are held
    against the plain versions; every chunk runs under sync debug 'error'
    and is read back by one fetch; each request's greedy tokens agree with a
    forward of its own history at >= 95 % of positions, and each image
    request's latents lie within the bf16 limits of its solo
    `sample(cache_kv=True)`. Returns the launch totals."""
    import numpy as np

    ServingEngine = mods["engine"].ServingEngine
    MultimodalServingEngine = mods["engine_mm"].MultimodalServingEngine
    serving = mods["serving"]
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    rng = np.random.default_rng(3)
    totals = dict.fromkeys(KERNELS, 0)

    # ---- the text engine ----
    name = "ServingEngine 8 rows, 24 requests"
    prompts, budgets = engine_text_workload(rng)
    kw = dict(max_batch=8, decode_chunk=64, temperature=0.0)
    # capture: the first 8 requests, 2 new tokens each, on an engine of the
    # same capacity (prefill rows by width bucket, decode at nq 1 over 8 rows)
    probe = ServingEngine.for_workload(model, prompts, budgets, **kw)
    with capturing(torch, mods, {
            "flash_fwd": lambda a: True,
            "decode_attn:nq1": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (8, 1)}) as calls:
        probe.run(prompts[:8], 2)
    torch.cuda.synchronize()
    text_rows = hold_captured(torch, mods, name, calls, {"flash_fwd", "decode_attn:nq1"})
    del calls, probe
    eng = ServingEngine.for_workload(model, prompts, budgets, **kw)
    t0 = time.perf_counter()
    eng.warmup(fit_cap_slope=True)
    t_warm = time.perf_counter() - t0
    for p, b in zip(prompts, budgets):
        eng.submit(p, b)
    t0 = time.perf_counter()
    graph_steps = eng.stats["graph_steps"]
    with chunk_watch(torch, mods, mods["engine"].DecodeGraph, "chunk") as stats:
        done, counts = counted(mods, eng.run)
    dt = time.perf_counter() - t0
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0, f"{name}: launches {counts}")
    require(stats["chunks"] > 0 and stats["fetches_after_chunk"] == stats["chunks"],
            f"{name}: chunk fetches {stats}")
    require(eng.stats["graph_steps"] - graph_steps == stats["ticks"],
            f"{name}: graph steps {eng.stats['graph_steps'] - graph_steps} of {stats['ticks']}")
    tokens = {r.rid: r.tokens for r in done}
    require(sorted(tokens) == list(range(ENGINE_REQUESTS))
            and all(len(tokens[i]) == budgets[i] for i in tokens), f"{name}: budgets")
    forced = [forced_agreement(torch, model, [np.concatenate([p, np.asarray(tokens[i])])],
                               len(tokens[i]), text_only=True) for i, p in enumerate(prompts)]
    require(float(np.mean(forced)) >= 0.95, f"{name}: per-position token agreement {forced}")
    for k in totals:
        totals[k] += counts[k]
    generated = sum(budgets)
    static_cap = -(-max(p.size + b for p, b in zip(prompts, budgets)) // 128) * 128
    static_step = eng.static_step_at(static_cap)
    fit = {"rtt_s": eng._rtt_est, "step_s": eng._step_est, "cap_slope_s_per_slot": eng._cap_slope,
           "fit": eng.cost_fit, "samples": {k: v[1:] for k, v in eng._chunk_samples.items()},
           "static_step_s": static_step,
           "static_step_ratio": None if static_step is None else static_step / eng._step_est}
    log(json.dumps({"engine": name, "cap": eng.cap, "seconds": dt, "warmup_seconds": t_warm,
                    "requests_per_s": ENGINE_REQUESTS / dt, "tokens_per_s": generated / dt,
                    **watch_report(stats, dt), "admitted": eng.stats["admitted"],
                    "token_agreement_per_position": float(np.mean(forced)),
                    "min_token_agreement": float(np.min(forced)),
                    "admission_flash_row": text_rows, "cost_model": fit, "launches": counts}))

    # serve() on the same workload: the planner's choice and both estimates
    rtt, step = eng._rtt_est, eng._step_est
    est = {"engine_s": serving.estimate_engine_time(budgets, 8, rtt, step, 64),
           "static_s": serving.estimate_static_time(
               budgets, 8, rtt, static_step if static_step is not None
               else step * serving.STATIC_STEP_RATIO)}
    plans = []
    plan_dispatch = serving.plan_dispatch

    def spy_plan(*a, **k):
        plans.append(plan_dispatch(*a, **k))
        return plans[-1]

    # serve() as planned, then the other branch forced, to see whether the
    # planner chose the faster one
    seconds, agreement = {}, {}
    try:
        for forced_plan in (None, "other"):
            if forced_plan is None:
                serving.plan_dispatch = spy_plan
            else:
                branch = "engine" if plans[0] == "static" else "static"
                serving.plan_dispatch = lambda *a, _b=branch, **k: _b
            t0 = time.perf_counter()
            served, s_counts = counted(mods, lambda: eng.serve(prompts, budgets))
            branch = plans[0] if forced_plan is None else branch
            seconds[branch] = time.perf_counter() - t0
            require([len(t) for t in served] == budgets, f"{name}: serve() {branch}")
            forced_s = [forced_agreement(torch, model, [np.concatenate([p, np.asarray(t)])],
                                         len(t), text_only=True) for p, t in zip(prompts, served)]
            agreement[branch] = float(np.mean(forced_s))
            require(agreement[branch] >= 0.95, f"{name} serve() {branch}: agreement {forced_s}")
            for k in totals:
                totals[k] += s_counts[k]
    finally:
        serving.plan_dispatch = plan_dispatch
    require(len(plans) == 1, f"{name}: serve() planned {plans}")
    # the static branch: one prefill and max(budget) decode steps a pool
    by_budget = sorted(budgets, reverse=True)
    static_steps = sum(max(by_budget[i : i + 8]) for i in range(0, len(by_budget), 8))
    static_ms = seconds["static"] / static_steps * 1e3
    log(json.dumps({"engine": f"{name}, serve()", "plan": plans[0], **est,
                    "seconds": seconds, "requests_per_s": {
                        b: ENGINE_REQUESTS / t for b, t in seconds.items()},
                    "tokens_per_s": {b: generated / t for b, t in seconds.items()},
                    "planned_branch_faster": seconds[plans[0]] == min(seconds.values()),
                    "static_steps": static_steps, "static_ms_per_step": static_ms,
                    "measured_static_step_ratio": static_ms / watch_report(stats, dt)["ms_per_tick"],
                    "token_agreement_per_position": agreement}))

    # ---- the multimodal engine ----
    name = "MultimodalServingEngine 4 requests (8 rows), 8 requests"
    noise = rng.standard_normal((196, 32)).astype(np.float32)
    mm_prompts = ([[np.asarray(list(rng.integers(0, 256, n)) + [model.som_ids[0]], np.int32)]
                   for n in BATCH_IMAGE_TEXT]
                  + [[rng.integers(0, 256, n).astype(np.int32)] for n in BATCH_TEXT])
    max_length = 196 + 32
    mkw = dict(max_requests=4, cfg_scale=3.0, modality_steps=16, fixed_modality_shape=(14, 14),
               text_chunk=32, text_temperature=0.0, init_modality_noise=noise, kv_quantize=False)
    rows = 8
    probe = MultimodalServingEngine.for_workload(model, mm_prompts, max_length,
                                                 **{**mkw, "modality_steps": 2})
    with capturing(torch, mods, {
            "flash_fwd": lambda a: True,
            "decode_attn:nq1": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (rows, 1),
            "decode_attn:nq196": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (rows, 196),
    }) as calls:
        probe.run(mm_prompts, 1)
    torch.cuda.synchronize()
    mm_rows = hold_captured(torch, mods, name, calls,
                            {"flash_fwd", "decode_attn:nq1", "decode_attn:nq196"})
    del calls, probe
    eng = MultimodalServingEngine.for_workload(model, mm_prompts, max_length, **mkw)
    t0 = time.perf_counter()
    eng.warmup()
    t_warm = time.perf_counter() - t0
    plan = eng.serve(mm_prompts, max_length, plan_only=True)
    rids = [eng.submit(p, max_length) for p in mm_prompts]
    t0 = time.perf_counter()
    with chunk_watch(torch, mods) as stats:
        done, counts = counted(mods, eng.run)
    dt = time.perf_counter() - t0
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0, f"{name}: launches {counts}")
    require(stats["chunks"] > 0 and stats["fetches_after_chunk"] == stats["chunks"],
            f"{name}: chunk fetches {stats}")
    require(eng.stats["rebuilds"] == 0, f"{name}: {eng.stats['rebuilds']} rebuilds")
    outs = {f.rid: f.output for f in done}
    images = sum(isinstance(o, tuple) for out in outs.values() for o in out)
    # the image requests against their solo sample(cache_kv=True) (latents
    # within the bf16 limits, the common-prefix agreement logged); every
    # request's tokens judged position by position
    forced, prefix, worst = [], [], 0.0
    t_solo = time.perf_counter()
    solo_kw = {k: v for k, v in mkw.items() if k not in ("max_requests", "text_chunk")}
    for rid, p in zip(rids, mm_prompts):
        got = outs[rid]
        lats = [o[1] for o in got if isinstance(o, tuple)]
        require(all(np.isfinite(x).all() and x.shape[-1] == 32 for x in lats),
                f"{name}: latents")
        if lats:
            solo = model.sample(p, cache_kv=True, max_length=max_length, **solo_kw)
            a_, _, w_ = bf16_agreement(got, solo, f"{name}: a request vs its solo sample")
            prefix += a_
            worst = max(worst, w_)
        start = model._prompt_to_items(p)
        new_images = sum(isinstance(o, tuple) for o in got) - sum(
            isinstance(o, tuple) for o in start)
        sampled = text_len(got) - text_len(start) - new_images
        if sampled > 0:
            forced.append(forced_agreement(torch, model, got, sampled))
    t_solo = time.perf_counter() - t_solo
    require(forced and float(np.mean(forced)) >= 0.95,
            f"{name}: per-position token agreement {forced}")
    for k in totals:
        totals[k] += counts[k]
    mm_fit = {"rtt_s": eng._rtt_est, "step_s": eng._step_est, "fit": eng.cost_fit,
              "ode_s": eng.ode_cost(), "samples": {k: v[1:] for k, v in eng._chunk_samples.items()}}
    log(json.dumps({"engine": name, "cap": eng.cap, "seconds": dt, "warmup_seconds": t_warm,
                    "requests_per_s": len(mm_prompts) / dt,
                    "tokens_per_s": sum(text_len(o) for o in outs.values()) / dt,
                    "images": images, "s_per_image": dt / max(images, 1),
                    **watch_report(stats, dt), "ode_dispatches": eng.stats["ode_dispatches"],
                    "rebuilds": eng.stats["rebuilds"], "plan": plan,
                    "token_agreement_per_position": float(np.mean(forced)),
                    "token_agreement_over_common_prefix_vs_solo": prefix,
                    "latents_vs_solo_of_bf16_limit": worst, "solo_seconds": t_solo,
                    "admission_flash_row": mm_rows, "cost_model": mm_fit, "launches": counts}))
    del model, eng
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 4d: the image workloads' options at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def raw_items(model):
    """While open, keep the undecoded items that reach the model's
    `decode_modalities` (the samplers decode their results there); the
    call's own result stays the decoded one."""
    seen, decode = [], model.decode_modalities

    def spy(samples):
        seen.append(samples)
        return decode(samples)

    model.decode_modalities = spy
    try:
        yield seen
    finally:
        model.decode_modalities = decode


def images_ok(np, items, what):
    """Every modality of the items a decoded [28, 28, 8] image in [0, 1]."""
    imgs = [o[1] for o in items if isinstance(o, tuple)]
    require(all(x.shape == IMAGE_SHAPE and np.isfinite(x).all() and x.min() >= 0.0
                and x.max() <= 1.0 for x in imgs), f"{what}: decoded images")
    return len(imgs)


def image_step_capture(torch, mods, trainer, state, packed, draws, name):
    """One velocity step whose attention calls are captured; the first
    forward (the trained pass) and its backward are held against their
    plain versions. Returns (state, {kernel: result})."""
    with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                 "flash_fwd_nhd": lambda a: True}) as calls:
        state, _ = trainer.train_step(state, packed, draws=draws)
    torch.cuda.synchronize()
    key = "flash_fwd_nhd" if "flash_fwd_nhd" in calls else "flash_fwd"
    require(key in calls and "do" in calls[key], f"{name}: no attention call captured")
    a = calls[key]
    if key == "flash_fwd_nhd":
        shape = f"main path, {name}: q {shape_str(a['q'])} rope spans {shape_str(a['spans'])}"
        f_res, b_res = check_nhd(torch, mods, a)
        return state, {"flash_fwd_nhd": record("flash_fwd_nhd", shape, f_res, torch.bfloat16),
                       "flash_bwd_nhd": record("flash_bwd_nhd", shape, b_res, torch.bfloat16)}
    shape = f"main path, {name}: q {shape_str(a['q'])} spans {shape_str(a['spans'])}"
    return state, {
        "flash_fwd": record("flash_fwd", shape, check_flash(torch, mods, a, iters=5),
                            torch.bfloat16),
        "flash_bwd": record("flash_bwd", shape, check_flash_bwd(torch, mods, a), torch.bfloat16)}


def phase_image(torch, Transfusion, Trainer, mods):
    """The bench model at full width with a patch encoder / decoder, U-Net
    halves (49 rows an image), axial pos-emb and the reconstruction and
    velocity-consistency terms: 20 `Trainer(velocity_consistency=True)`
    steps, cached `sample()`, `sample_batch` (R 8) and the multimodal
    engine (4 requests, 8 rows), each returning decoded images, and one
    `forward_modality` loss. Returns the launch totals."""
    import numpy as np

    model = image_model(torch, Transfusion, mods, "cuda", torch.bfloat16, BENCH_CFG, 0)
    require(model.seq_shape_for(0, (14, 14)) == (7, 7), "image model: seq shape")
    depth = BENCH_CFG["transformer"]["depth"]
    rng = np.random.default_rng(7)
    totals = dict.fromkeys(KERNELS, 0)

    # ---- training ----
    name = "image model 32 x [32 text][28x28x8 image][8 text], velocity + recon"
    trainer = Trainer(model, learning_rate=3e-4, velocity_consistency=True)
    batch = [[rng.integers(0, 256, 32).astype(np.int32),
              (0, rng.uniform(size=IMAGE_SHAPE).astype(np.float32)),
              rng.integers(0, 256, 8).astype(np.int32)] for _ in range(32)]
    packed = trainer._packed(batch)  # encoded, then packed
    require(int(packed.spans[0, 0, 2]) == IMAGE_ROWS, f"{name}: span {packed.spans[0, 0]}")
    state = trainer.init_state()
    draws = model.make_draws(packed, torch.Generator("cuda").manual_seed(0), velocity=True)
    state, main = image_step_capture(torch, mods, trainer, state, packed, draws, name)
    fwd, bwd = list(main)

    def steps(state=state):
        losses = []
        for _ in range(TRAIN_STEPS):
            state, metrics = trainer.train_step(state, packed, draws=draws)
            losses.append(metrics)
        return state, [{k: float(v) for k, v in m.items()} for m in losses]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, metrics), counts = counted(mods, steps)
    dt = time.perf_counter() - t0
    by_row = {w: dict(mods["counters"][w].launches_by_row) for w in ("flash_fwd", "flash_bwd")}
    losses = [m["loss"] for m in metrics]
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{name}: loss did not fall {losses[0]} -> {losses[-1]}")
    # the trained forward and the EMA forward, one backward, per layer and step
    require(counts[fwd] == 2 * depth * TRAIN_STEPS and counts[bwd] == depth * TRAIN_STEPS,
            f"{name}: launches {counts}, want {2 * depth * TRAIN_STEPS} of {fwd} and "
            f"{depth * TRAIN_STEPS} of {bwd}")
    for k in totals:
        totals[k] += counts[k]
    # the EMA pass's share: its forwards timed alone over 3 more steps
    ema_s, joint = [0.0], model._joint_core

    def timed_joint(*a, **k):
        if torch.is_grad_enabled():
            return joint(*a, **k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = joint(*a, **k)
        torch.cuda.synchronize()
        ema_s[0] += time.perf_counter() - t
        return out

    model._joint_core = timed_joint
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            state, _ = trainer.train_step(state, packed, draws=draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter() - t1
    finally:
        model._joint_core = joint
    log(json.dumps({
        "image": f"training, {name}", "steps": TRAIN_STEPS, "seconds": dt,
        "ms_per_step": dt / TRAIN_STEPS * 1e3,
        "packed_tokens_per_s": int(packed.total_tokens) * TRAIN_STEPS / dt,
        "tokens_per_step": int(packed.total_tokens), "n": int(packed.text.shape[1]) - 1,
        "ema_pass_ms_per_step": ema_s[0] / 3 * 1e3, "ema_pass_share_of_step": ema_s[0] / t1,
        "first": metrics[0], "last": metrics[-1], "launches": counts,
        "launches_by_row": by_row}))

    # ---- modality-only loss: velocity against the trained EMA, recon decoded ----
    x = rng.uniform(size=(8, *IMAGE_SHAPE)).astype(np.float32)
    total, parts = model.forward_modality(
        x, generator=torch.Generator("cuda").manual_seed(1),
        velocity_consistency_ema_params=state.ema.params, return_loss_breakdown=True)
    parts = [float(v) for v in parts]
    require(np.isfinite(float(total)) and all(np.isfinite(parts)) and parts[1] > 0
            and parts[2] > 0, f"forward_modality: {float(total)}, parts {parts}")
    log(json.dumps({"image": "forward_modality b8, velocity + recon through the decoder",
                    "loss": float(total), "flow_velocity_recon": parts}))
    # sampling runs on the seeded weights, as phases 4b and 4c do: 20 steps
    # on uniform random text flatten the text logits into near-ties that
    # bf16 rounding decides, below the 95 % per-position contract
    del trainer, state, packed, draws

    noise = rng.standard_normal((196, 32)).astype(np.float32)
    skw = dict(text_temperature=0.0, cfg_scale=3.0, modality_steps=16,
               fixed_modality_shape=(14, 14), init_modality_noise=noise, kv_quantize=False)
    # ---- cached sample() ----
    name = "image model sample(cache_kv=True) cfg 3.0"
    prompt = [np.asarray(list(rng.integers(0, 256, 24)) + [model.som_ids[0]], np.int32)]
    with capturing(torch, mods, {
            "flash_fwd": lambda a: True,
            "decode_attn:nq1": lambda a: a["q"].shape[2] == 1,
            "decode_attn:nq49": lambda a: a["q"].shape[2] == IMAGE_ROWS}) as calls:
        model.sample(prompt, cache_kv=True, **{**skw, "modality_steps": 2, "max_length": 52})
    torch.cuda.synchronize()
    hold_captured(torch, mods, name, calls, {"flash_fwd", "decode_attn:nq1", "decode_attn:nq49"})
    del calls
    t0 = time.perf_counter()
    with raw_items(model) as raw:
        out, counts = counted(mods, lambda: model.sample(prompt, cache_kv=True,
                                                         max_length=IMAGE_ROWS + 16, **skw))
    dt = time.perf_counter() - t0
    images = images_ok(np, out, name)
    require(images >= 1 and counts["flash_fwd"] > 0 and counts["decode_attn"] > 0,
            f"{name}: {images} images, launches {counts}")
    sampled = text_len(raw[0]) - text_len(model._prompt_to_items(prompt)) - images
    forced = forced_agreement(torch, model, raw[0], sampled) if sampled > 0 else None
    for k in totals:
        totals[k] += counts[k]
    log(json.dumps({"image": name, "seconds": dt, "s_per_image": dt, "text_sampled": sampled,
                    "token_agreement_per_position": forced, "launches": counts}))

    # ---- sample_batch R 8 and the multimodal engine, each request against
    # its solo sample(cache_kv=True) ----
    prompts = ([[np.asarray(list(rng.integers(0, 256, n)) + [model.som_ids[0]], np.int32)]
                for n in BATCH_IMAGE_TEXT]
               + [[rng.integers(0, 256, n).astype(np.int32)] for n in BATCH_TEXT])
    max_length = IMAGE_ROWS + 32
    solos = []
    for p in prompts:
        with raw_items(model) as raw:
            model.sample(p, cache_kv=True, max_length=max_length, **skw)
        solos.append(raw[0])

    def judge(name, outs, raws, seconds, counts, extra):
        images = sum(images_ok(np, o, name) for o in outs)
        forced, prefix, worst = [], [], 0.0
        for p, got, solo in zip(prompts, raws, solos):
            a_, _, w_ = bf16_agreement(got, solo, f"{name}: a request vs its solo sample")
            prefix += a_
            worst = max(worst, w_)
            start = model._prompt_to_items(p)
            new_images = sum(isinstance(o, tuple) for o in got) - sum(
                isinstance(o, tuple) for o in start)
            n_sampled = text_len(got) - text_len(start) - new_images
            if n_sampled > 0:
                forced.append(forced_agreement(torch, model, got, n_sampled))
        require(forced and float(np.mean(forced)) >= 0.95,
                f"{name}: per-position token agreement {forced}")
        for k in totals:
            totals[k] += counts[k]
        log(json.dumps({"image": name, "seconds": seconds,
                        "requests_per_s": len(prompts) / seconds, "images": images,
                        "s_per_image": seconds / max(images, 1),
                        "token_agreement_per_position": float(np.mean(forced)),
                        "token_agreement_over_common_prefix_vs_solo": prefix,
                        "latents_vs_solo_of_bf16_limit": worst, **extra, "launches": counts}))

    name = "image model sample_batch R 8 cfg 3.0"
    bkw = dict(skw, max_length=max_length, text_chunk=32)
    rows = 2 * len(prompts)
    with capturing(torch, mods, {
            "decode_attn:nq1": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (rows, 1),
            "decode_attn:nq49": lambda a: (a["q"].shape[0], a["q"].shape[2]) == (rows, IMAGE_ROWS),
    }) as calls:
        model.sample_batch(prompts, **{**bkw, "modality_steps": 2, "max_length": IMAGE_ROWS + 2})
    torch.cuda.synchronize()
    hold_captured(torch, mods, name, calls, {"decode_attn:nq1", "decode_attn:nq49"})
    del calls
    t0 = time.perf_counter()
    with raw_items(model) as raws, chunk_watch(torch, mods) as stats:
        outs, counts = counted(mods, lambda: model.sample_batch(prompts, **bkw))
    dt = time.perf_counter() - t0
    require(stats["chunks"] > 0 and stats["fetches_after_chunk"] == stats["chunks"],
            f"{name}: chunk fetches {stats}")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0, f"{name}: launches {counts}")
    judge(name, outs, raws, dt, counts, {
        "ms_per_text_tick": stats["chunk_seconds"] / stats["ticks"] * 1e3,
        "host_fetches_per_chunk": stats["fetches_after_chunk"] / stats["chunks"]})

    name = "image model MultimodalServingEngine 4 requests (8 rows), 8 requests"
    ekw = {k: v for k, v in bkw.items() if k != "max_length"}
    eng = mods["engine_mm"].MultimodalServingEngine.for_workload(
        model, prompts, max_length, max_requests=4, **ekw)
    rids = [eng.submit(p, max_length) for p in prompts]
    t0 = time.perf_counter()
    with chunk_watch(torch, mods) as stats:
        done, counts = counted(mods, eng.run)
    dt = time.perf_counter() - t0
    require(stats["chunks"] > 0 and stats["fetches_after_chunk"] == stats["chunks"],
            f"{name}: chunk fetches {stats}")
    require(eng.stats["rebuilds"] == 0, f"{name}: {eng.stats['rebuilds']} rebuilds")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0, f"{name}: launches {counts}")
    by_rid = {f.rid: f for f in done}
    judge(name, [by_rid[r].output for r in rids], [by_rid[r].items for r in rids], dt, counts,
          {"ms_per_tick": stats["chunk_seconds"] / stats["ticks"] * 1e3,
           "ode_dispatches": eng.stats["ode_dispatches"]})
    del model, eng
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 4e: the example recipes' options at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def logged(name):
    """While open, keep the messages that the logger `name` emits at INFO."""
    import logging

    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger, handler = logging.getLogger(name), Keep(logging.INFO)
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def phase_recipes(torch, Transfusion, Trainer, mods):
    """The bench model (bf16) with the recipes' LASER and 4 residual streams
    of 4 fracs: 20 `Trainer(optimizer=muon_adam_atan2(...))` steps on
    bench.py's batch and cached `sample()` on the seeded weights (no decode
    launch: LASER's cached steps take the dense path, logged); then the
    `train_text_only.py` recipe at its own width: 8 calls of
    chain(clip 0.5, MultiSteps(adam(3e-4), 4)) through `_text_loss_impl`
    with the EMA advancing on every call, and `generate_text_batch`. The
    captured row-1, row-2, row-5 and row-6 calls are held against their
    plain versions (`laser`). Returns the launch totals."""
    import numpy as np

    from transfusion_tpu_torch.training import (
        MultiSteps,
        adam,
        apply_updates,
        chain,
        clip_by_global_norm,
        ema_update,
        init_ema,
        muon_adam_atan2,
    )

    depth = BENCH_CFG["transformer"]["depth"]
    cfg = dict(BENCH_CFG, transformer=dict(BENCH_CFG["transformer"], **RECIPE_OPTS))
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **cfg)
    rng = np.random.default_rng(11)
    totals = dict.fromkeys(KERNELS, 0)

    # ---- training: bench.py's batch, n 256, the token-major route ----
    name = "LASER + 4 streams, bench batch 32 x [32 text][14x14x32][8 text], Muon"
    trainer = Trainer(model, optimizer=muon_adam_atan2(muon_lr=3e-4, adam_lr=3e-4),
                      grad_clip_norm=0.5)
    packed = model.pack([bench_sample(rng, 1) for _ in range(32)], shift_friendly=True)
    require(packed.text.shape[1] == 257, f"{name}: packed to {packed.text.shape}")
    packed = packed.to_torch("cuda")
    state = trainer.init_state()
    draws = model.make_draws(packed, torch.Generator("cuda").manual_seed(0))
    with capturing(torch, mods, {"flash_fwd_nhd": lambda a: True}) as calls:
        state, _ = trainer.train_step(state, packed, draws=draws)
    torch.cuda.synchronize()
    require("flash_fwd_nhd" in calls and "do" in calls["flash_fwd_nhd"],
            f"{name}: no token-major attention call captured")
    a = calls["flash_fwd_nhd"]
    shape = f"main path, {name}: q {shape_str(a['q'])} rope spans {shape_str(a['spans'])}, LASER"
    f_res, b_res = check_nhd(torch, mods, a, laser=True)
    record("flash_fwd_nhd", shape, f_res, torch.bfloat16)
    record("flash_bwd_nhd", shape, b_res, torch.bfloat16)
    del calls

    def steps(state=state):
        out = []
        for _ in range(TRAIN_STEPS):
            state, metrics = trainer.train_step(state, packed, draws=draws)
            out.append(metrics["loss"])
        return state, [float(x) for x in out]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, losses), counts = counted(mods, steps)
    dt = time.perf_counter() - t0
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{name}: loss did not fall {losses[0]} -> {losses[-1]}")
    want = depth * TRAIN_STEPS
    require(counts["flash_fwd_nhd"] == want and counts["flash_bwd_nhd"] == want,
            f"{name}: launches {counts}, want {want} of rows 5 and 6")
    for k in totals:
        totals[k] += counts[k]
    # the optimizer update's share: clip + Muon / Adam-atan2 + apply + EMA,
    # timed alone over 3 more steps
    upd_s, apply = [0.0], trainer._apply

    def timed_apply(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = apply(*a, **k)
        torch.cuda.synchronize()
        upd_s[0] += time.perf_counter() - t
        return out

    trainer._apply = timed_apply
    try:
        for _ in range(3):
            state, _ = trainer.train_step(state, packed, draws=draws)
    finally:
        trainer._apply = apply
    log(json.dumps({
        "recipes": f"training, {name}", "steps": TRAIN_STEPS, "seconds": dt,
        "ms_per_step": dt / TRAIN_STEPS * 1e3,
        "packed_tokens_per_s": int(packed.total_tokens) * TRAIN_STEPS / dt,
        "tokens_per_step": int(packed.total_tokens), "optimizer_update_ms": upd_s[0] / 3 * 1e3,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": counts}))
    del trainer, state, packed, draws

    # ---- cached sample() on the seeded weights: the dense cached path ----
    name = "LASER + 4 streams sample(cache_kv=True) cfg 3.0"
    noise = rng.standard_normal((196, 32)).astype(np.float32)
    prompt = [np.asarray(list(rng.integers(0, 256, 24)) + [model.som_ids[0]], np.int32)]
    kw = dict(text_temperature=0.0, cfg_scale=3.0, modality_steps=16, cache_kv=True,
              fixed_modality_shape=(14, 14), init_modality_noise=noise, kv_quantize=False)
    with capturing(torch, mods, {"flash_fwd": lambda a: True}) as calls:
        model.sample(prompt, max_length=196, **{**kw, "modality_steps": 2})
    torch.cuda.synchronize()
    a = calls["flash_fwd"]
    b, h, nq, d = a["q"].shape
    row = mods["flash"].tpu_row(h, nq, a["k"].shape[2], d, bwd=False)
    require(row == 1, f"{name}: prefill q {shape_str(a['q'])} is row {row}, not 1")
    record("flash_fwd", f"main path, {name}: prefill q {shape_str(a['q'])} (row 1), LASER",
           check_flash(torch, mods, a, laser=True), torch.bfloat16)
    del calls
    t0 = time.perf_counter()
    with logged("transfusion_tpu_torch.models.transformer") as messages:
        out, counts = counted(mods, lambda: model.sample(prompt, max_length=196, **kw))
    dt = time.perf_counter() - t0
    lat = [o[1] for o in out if isinstance(o, tuple)]
    require(len(lat) == 1 and lat[0].shape == (14, 14, 32) and np.isfinite(lat[0]).all(),
            f"{name}: latents {[x.shape for x in lat]}")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] == 0,
            f"{name}: launches {counts}")
    excluded = "decode kernel excluded for this cached step (LASER attention)"
    require(any(excluded in m for m in messages), f"{name}: the exclusion was not logged")
    for k in totals:
        totals[k] += counts[k]
    log(json.dumps({"recipes": name, "s_per_image": dt, "launches": counts,
                    "exclusions_logged": sum(excluded in m for m in messages)}))
    del model

    # ---- examples/train_text_only.py at its own width ----
    name = "train_text_only recipe: 4 x 257 bytes, clip 0.5 + MultiSteps(adam(3e-4), 4)"
    tmodel = Transfusion(device="cuda", dtype=torch.bfloat16, seed=1, num_text_tokens=256,
                         dim_latent=384, modality_default_shape=(),
                         transformer=dict(dim=384, depth=8, dim_head=64, heads=8,
                                          attn_impl="flash", attn_laser=True))
    tx = chain(clip_by_global_norm(0.5), MultiSteps(adam(3e-4), every_k_schedule=4))
    params = {k: p.detach().float().clone() for k, p in tmodel.core.named_parameters()}
    opt_state, ema = tx.init(params), init_ema(params)
    data = torch.as_tensor(rng.integers(0, 256, (8, 4, 257)), device="cuda")

    def text_steps(params=params, opt_state=opt_state, ema=ema):
        out = []
        for batch in data:
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            loss = tmodel._text_loss_impl(batch, params=leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(leaves.items(), grads)}
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates({k: p.detach() for k, p in params.items()}, updates)
            ema = ema_update(ema, params)
            out.append(float(loss.detach()))
        return out, opt_state, ema

    t0 = time.perf_counter()
    (losses, opt_state, ema), counts = counted(mods, text_steps)
    dt = time.perf_counter() - t0
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(opt_state[1]["gradient_step"] == 2 and ema.step == 8,
            f"{name}: {opt_state[1]['gradient_step']} updates, EMA step {ema.step}")
    require(counts["flash_fwd_nhd"] == 8 * 8 and counts["flash_bwd_nhd"] == 8 * 8,
            f"{name}: launches {counts}")
    for k in totals:
        totals[k] += counts[k]
    log(json.dumps({"recipes": name, "calls": 8, "updates": 2, "seconds": dt,
                    "ms_per_call": dt / 8 * 1e3, "losses": losses, "launches": counts}))

    name = "train_text_only model generate_text_batch, 4 prompts of 300-480 bytes"
    prompts = [rng.integers(0, 256, n) for n in (300, 360, 420, 480)]
    with capturing(torch, mods, {"flash_fwd": lambda a: True}) as calls:
        toks, counts = counted(mods, lambda: tmodel.generate_text_batch(
            prompts, max_new_tokens=32, temperature=0.0))
    torch.cuda.synchronize()
    a = calls["flash_fwd"]
    b, h, nq, d = a["q"].shape
    row = mods["flash"].tpu_row(h, nq, a["k"].shape[2], d, bwd=False)
    require(row == 2, f"{name}: prefill q {shape_str(a['q'])} is row {row}, not 2")
    record("flash_fwd", f"main path, {name}: prefill q {shape_str(a['q'])} (row 2), LASER",
           check_flash(torch, mods, a, laser=True), torch.bfloat16)
    toks = toks.cpu()
    require(tuple(toks.shape) == (4, 32) and bool(((toks >= 0) & (toks < 256)).all()),
            f"{name}: tokens {tuple(toks.shape)}")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] == 0, f"{name}: launches {counts}")
    for k in totals:
        totals[k] += counts[k]
    log(json.dumps({"recipes": name, "launches": counts}))
    return totals


# ---------------------------------------------------------------------------
# phase 4f: the single-process user surface at full width
# ---------------------------------------------------------------------------

SURFACE_SAMPLES, SURFACE_BATCH = 64, 32
# the example twins, each with --device cuda and these flags
TWINS = {name: ["--steps", "3", "--sample-every", "3"] for name in (
    "train_toy", "train_text_only", "train_mnist", "train_mnist_with_unet", "train_image_only",
    "train_image_only_with_unet", "train_latent_only", "train_latent_with_text")}
TWINS["train_mnist_vae"] = ["--steps", "3", "--sample-every", "3", "--ae-steps", "5"]
TWINS["serve_text"] = ["--ragged", "--engine", "--mm-engine", "--multimodal"]


def row_of(mods, a):
    """The TPU kernel-table row of a captured flash_attention call."""
    b, h, nq, d = a["q"].shape
    return mods["flash"].tpu_row(h, nq, a["k"].shape[2], d, bwd=False)


def surface_packer(spec, samples):
    """One bench-shaped `pack_samples` call (32 samples) with use_native
    True and False: equal arrays; the median ms of each over 20 calls, and
    of the native path's parts (flattening the descriptors in Python, the
    native pass) beside the numpy assembly, on the host."""
    import numpy as np

    from transfusion_tpu_torch.data import packing

    def ms(fn, reps=20):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return float(np.median(times)) * 1e3

    native, kw = packing._assemble_native, dict(shift_friendly=True)
    seen = []

    def keep(*args):
        seen.append(args)
        return native(*args)

    packing._assemble_native = keep
    try:
        got = packing.pack_samples(samples, spec, use_native=True, **kw)
    finally:
        packing._assemble_native = native
    want = packing.pack_samples(samples, spec, use_native=False, **kw)
    for f in ("text", "cfg_mask", "spans", "lengths"):
        g, w = getattr(got, f), getattr(want, f)
        require(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                f"native packer: {f} differs from the numpy path's")
    desc, n, m = seen[0]
    log(json.dumps({
        "surface": f"pack_samples, {len(samples)} bench samples to n {n} (host)",
        "native_ms": ms(lambda: packing.pack_samples(samples, spec, use_native=True, **kw)),
        "numpy_ms": ms(lambda: packing.pack_samples(samples, spec, use_native=False, **kw)),
        "assemble_numpy_ms": ms(lambda: packing._assemble(desc, n, m)),
        "assemble_native_ms (flatten + native pass)": ms(lambda: native(desc, n, m)),
        "flatten_ms": ms(lambda: packing._flatten(desc))}))


def surface_training(torch, Transfusion, Trainer, mods, totals):
    """(a) `PackingLoader` over 64 bench-shaped samples feeding the bench
    model (its batches assembled by the native packer): `train_steps` over
    two of its batches, then `train_step` on its next 10, timing the waits
    in `next()`; then `surface_packer` on 32 of the samples."""
    import numpy as np

    from transfusion_tpu_torch.data import packing
    from transfusion_tpu_torch.data.dataloader import PackingLoader

    depth = BENCH_CFG["transformer"]["depth"]
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    trainer = Trainer(model, learning_rate=3e-4)
    rng = np.random.default_rng(21)
    dataset = [bench_sample(rng, 1) for _ in range(SURFACE_SAMPLES)]
    gen = torch.Generator("cuda").manual_seed(0)
    name = f"PackingLoader {SURFACE_SAMPLES} x bench sample, batch {SURFACE_BATCH}"
    native, native_calls = packing._assemble_native, [0]

    def counted_native(*args):
        native_calls[0] += 1
        return native(*args)

    packing._assemble_native = counted_native
    t0 = time.perf_counter()
    loader = PackingLoader(model, dataset, batch_size=SURFACE_BATCH, prefetch=2, seed=0)
    try:
        b0 = next(loader)
        first_batch_s = time.perf_counter() - t0
        b1 = next(loader)
        require(b0.text.shape == b1.text.shape == (SURFACE_BATCH, 257),
                f"{name}: packed to {b0.text.shape}, {b1.text.shape}")
        state = trainer.init_state()
        with capturing(torch, mods, {"flash_fwd_nhd": lambda a: True}) as calls:
            state, m0 = trainer.train_step(state, b0, generator=gen)
        torch.cuda.synchronize()
        require("do" in calls.get("flash_fwd_nhd", {}), f"{name}: no token-major call captured")
        a = calls["flash_fwd_nhd"]
        shape = f"main path, {name}: q {shape_str(a['q'])} rope spans {shape_str(a['spans'])}"
        f_res, b_res = check_nhd(torch, mods, a)
        record("flash_fwd_nhd", shape, f_res, torch.bfloat16)
        record("flash_bwd_nhd", shape, b_res, torch.bfloat16)
        del calls, a

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, metrics), counts = counted(
            mods, lambda: trainer.train_steps(state, [b0, b1], TRAIN_STEPS, generator=gen))
        dt = time.perf_counter() - t0
        want = depth * TRAIN_STEPS
        require(counts["flash_fwd_nhd"] == want and counts["flash_bwd_nhd"] == want,
                f"{name}: train_steps launches {counts}, want {want} of rows 5 and 6")
        require(np.isfinite(float(metrics["loss"])), f"{name}: loss {metrics['loss']}")
        for k in totals:
            totals[k] += counts[k]

        waits, losses = [], [float(m0["loss"])]

        def loader_steps(state=state):
            for _ in range(10):
                t = time.perf_counter()
                batch = next(loader)
                waits.append(time.perf_counter() - t)
                state, m = trainer.train_step(state, batch, generator=gen)
                losses.append(float(m["loss"]))
            return state

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, counts2 = counted(mods, loader_steps)
        dt2 = time.perf_counter() - t1
    finally:
        loader.close()
        packing._assemble_native = native
    require(native_calls[0] >= 12, f"{name}: {native_calls[0]} batches from the native packer")
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(counts2["flash_fwd_nhd"] == depth * 10 and counts2["flash_bwd_nhd"] == depth * 10,
            f"{name}: loader steps launches {counts2}")
    for k in totals:
        totals[k] += counts2[k]
    log(json.dumps({
        "surface": f"training, {name}", "train_steps": TRAIN_STEPS, "seconds": dt,
        "ms_per_step": dt / TRAIN_STEPS * 1e3,
        "packed_tokens_per_s": int(b0.total_tokens) * TRAIN_STEPS / dt,
        "row5_row6_launches_per_step": [counts["flash_fwd_nhd"] / TRAIN_STEPS,
                                        counts["flash_bwd_nhd"] / TRAIN_STEPS],
        "loss_first": losses[0], "loss_after_train_steps": float(metrics["loss"]),
        "loss_last": losses[-1], "first_batch_s": first_batch_s,
        "loader_steps_ms_per_step": dt2 / 10 * 1e3, "mean_next_wait_ms": 1e3 * sum(waits) / 10,
        "max_next_wait_ms": 1e3 * max(waits), "native_packer_batches": native_calls[0],
        "launches": counts}))
    surface_packer(model.pack_spec, dataset[:SURFACE_BATCH])


def surface_dropout(torch, Transfusion, mods):
    """(b) A small float32 dropout model's joint forward and backward with
    the same keep masks, card against CPU, on the dense route (attention
    and feedforward masks) and the flash route (feedforward masks); then the
    bench model with dropout 0.1 against its dropout-0 twin (same weights):
    cached `sample()` and `loss(train=False)` equal, `loss(train=True)`
    refused."""
    import numpy as np

    rng = np.random.default_rng(5)
    batch = [[rng.integers(0, 16, 6).astype(np.int32),
              (0, rng.standard_normal((4, 4, 8)).astype(np.float32)),
              rng.integers(0, 16, 3).astype(np.int32)], [rng.integers(0, 16, 11).astype(np.int32)]]
    errs = {}
    for attn_impl in ("dense", "flash"):
        cfg = dict(SMALL_CFG, transformer=dict(SMALL_CFG["transformer"], attn_impl=attn_impl,
                                               dropout=0.1))
        models = {"cuda": Transfusion(device="cuda", dtype=torch.float32, seed=4, **cfg),
                  "cpu": Transfusion(device="cpu", dtype=torch.float32, seed=4, **cfg)}
        models["cpu"].core.load_state_dict(
            {k: v.cpu() for k, v in models["cuda"].core.state_dict().items()})
        packed = models["cpu"].pack(batch, shift_friendly=True)
        b, n = packed.text.shape
        masks = models["cpu"].core.transformer.draw_dropout_masks(
            torch.Generator().manual_seed(0), b, n, spans=packed.spans, device="cpu")
        route = "dense" if masks[0]["attn"] is not None else "flash"
        require(all(m["ff"] is not None and (m["attn"] is not None) == (attn_impl == "dense")
                    for m in masks), f"dropout masks of the {attn_impl} model")
        out = {}
        for dev, m in models.items():
            leaves = {k: p.detach().clone().requires_grad_(True)
                      for k, p in m.core.named_parameters()}
            p = packed.to_torch(dev)
            times = torch.full(p.spans.shape[:2], 0.4, device=dev)
            dmasks = [{k: None if v is None else v.to(dev) for k, v in d.items()} for d in masks]
            logits, _, flows, _, _ = torch.func.functional_call(
                m.core, leaves, (p, times), {"dropout": dmasks})
            g = torch.Generator().manual_seed(1)
            w_l = torch.randn(logits.shape, generator=g).to(dev) / logits.numel() ** 0.5
            w_f = torch.randn(flows[0].shape, generator=g).to(dev) / flows[0].numel() ** 0.5
            score = (logits * w_l).sum() + (flows[0] * w_f).sum()
            grads = torch.autograd.grad(score, list(leaves.values()), allow_unused=True)
            out[dev] = [logits.detach().cpu(), flows[0].detach().cpu()] + [
                torch.zeros(1) if x is None else x.cpu() for x in grads]
        err = max((a - b).abs().max().item() for a, b in zip(out["cuda"], out["cpu"]))
        require(err <= 1e-4, f"dropout {attn_impl} ({route} route) card vs cpu: {err}")
        errs[f"{attn_impl} ({route} route)"] = err

    cfg = dict(BENCH_CFG, transformer=dict(BENCH_CFG["transformer"], dropout=0.1))
    drop = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **cfg)
    plain = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    sd = plain.core.state_dict()
    require(all(torch.equal(v, sd[k]) for k, v in drop.core.state_dict().items()),
            "dropout model weights differ from the dropout-0 model's")
    noise = rng.standard_normal((196, 32)).astype(np.float32)
    prompt = [np.asarray(list(rng.integers(0, 256, 24)) + [plain.som_ids[0]], np.int32)]
    kw = dict(text_temperature=0.0, cfg_scale=3.0, modality_steps=16, cache_kv=True,
              init_modality_noise=noise, max_length=212)
    outs = [m.sample(prompt, **kw) for m in (drop, plain)]
    items_err(outs[0], outs[1], "dropout vs dropout-0 sample")
    require(all(not isinstance(x, tuple) or np.array_equal(x[1], y[1])
                for x, y in zip(*outs)), "dropout vs dropout-0 sample: latents differ")
    samples = [bench_sample(rng, 1) for _ in range(4)]
    packed = plain.pack(samples, shift_friendly=True).to_torch("cuda")
    draws = plain.make_draws(packed, torch.Generator("cuda").manual_seed(2))
    losses = [m.loss(packed=packed, draws=draws, train=False) for m in (drop, plain)]
    require(torch.equal(losses[0], losses[1]), f"loss(train=False) {losses}")
    try:
        drop.loss(packed=packed, draws=draws, train=True)
    except ValueError as e:
        require("needs PRNG" in str(e), f"loss(train=True) refused with {e}")
    else:
        raise SmokeFailure("loss(train=True) with dropout was not refused")
    log(json.dumps({"surface": "dropout", "small_f32_card_vs_cpu_err": errs,
                    "bench_sample_equal": True, "bench_eval_loss": float(losses[0]),
                    "train_loss_refused": True}))


def surface_reference(torch, Transfusion, mods, totals):
    """(c) The bench model's seeded weights exported as a transfusion-pytorch
    state_dict and loaded into a fresh model: logits bit-equal, cached
    `sample()` equal. Its row-1 prefill and decode calls and a
    `generate_text_batch` row-2 prefill are captured and held."""
    import numpy as np

    from transfusion_tpu_torch.models.port import export_to_reference, port_from_reference

    src = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    t0 = time.perf_counter()
    sd = export_to_reference(src)
    dst = Transfusion(device="cuda", dtype=torch.bfloat16, seed=7, **BENCH_CFG)
    port_from_reference(sd, dst)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 256, (2, 300))
    logits = [m.forward_text(ids, return_loss=False) for m in (src, dst)]
    require(torch.equal(logits[0], logits[1]), "ported logits are not bit-equal")
    noise = rng.standard_normal((196, 32)).astype(np.float32)
    prompt = [np.asarray(list(rng.integers(0, 256, 24)) + [src.som_ids[0]], np.int32)]
    kw = dict(text_temperature=0.0, cfg_scale=3.0, modality_steps=16, cache_kv=True,
              init_modality_noise=noise, max_length=212)
    want = {"flash_fwd": lambda a: row_of(mods, a) == 1, "decode_attn": lambda a: True}
    with capturing(torch, mods, want) as calls:
        out_src, counts = counted(mods, lambda: src.sample(prompt, **kw))
    out_dst = dst.sample(prompt, **kw)
    items_err(out_src, out_dst, "ported model's sample")
    require(all(not isinstance(x, tuple) or np.array_equal(x[1], y[1])
                for x, y in zip(out_src, out_dst)), "ported model's sampled latents differ")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0, f"sample launches {counts}")
    prompts = [rng.integers(0, 256, n) for n in (300, 360, 420, 480)]
    with capturing(torch, mods, {"flash_fwd": lambda a: row_of(mods, a) == 2}) as calls2:
        toks, counts2 = counted(mods, lambda: dst.generate_text_batch(
            prompts, max_new_tokens=32, temperature=0.0))
    require(tuple(toks.shape) == (4, 32), f"generate_text_batch tokens {tuple(toks.shape)}")
    require(set(calls) == {"flash_fwd", "decode_attn"} and "flash_fwd" in calls2,
            f"captured {sorted(calls)}, {sorted(calls2)}")
    name = "reference-checkpoint bench model"
    record("flash_fwd", f"main path, {name} sample(): prefill q {shape_str(calls['flash_fwd']['q'])}"
           " (row 1)", check_flash(torch, mods, calls["flash_fwd"]), torch.bfloat16)
    record("flash_fwd", f"main path, {name} generate_text_batch: prefill q "
           f"{shape_str(calls2['flash_fwd']['q'])} (row 2)",
           check_flash(torch, mods, calls2["flash_fwd"]), torch.bfloat16)
    dc = calls["decode_attn"]
    record("decode_attn", f"main path, {name} sample(): q {shape_str(dc['q'])} cache "
           f"{shape_str(dc['k'])}", check_decode(torch, mods, dc, count=True), torch.bfloat16)
    for k in totals:
        totals[k] += counts[k] + counts2[k]
    log(json.dumps({"surface": f"reference checkpoint, {name}", "keys": len(sd),
                    "export_and_load_s": load_s, "logits_bit_equal": True, "sample_equal": True,
                    "launches": {"sample": counts, "generate_text_batch": counts2}}))


def surface_twins():
    """(d) The ten example twins on the card, all started together, each in
    its own process; returns {name: (exit code, seconds, last loss or None,
    output tail)}."""
    import re

    workdir = os.path.join(HERE, "build", "example_twins")
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1")
    procs = {}
    for name, flags in TWINS.items():
        out = open(os.path.join(workdir, f"{name}.log"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"transfusion_tpu_torch.examples.{name}", "--device", "cuda",
             *flags], cwd=workdir, env=env, stdout=out, stderr=subprocess.STDOUT, text=True),
            out, time.perf_counter())
    results, deadline = {}, time.perf_counter() + 600
    try:
        while len(results) < len(procs):
            require(time.perf_counter() < deadline,
                    f"example twins still running after 600 s: {sorted(set(procs) - set(results))}")
            for name, (proc, out, t0) in procs.items():
                if name in results or proc.poll() is None:
                    continue
                seconds = time.perf_counter() - t0
                out.seek(0)
                text = out.read()
                losses = re.findall(r"^\d+: (?:train )?([-+0-9.eE]+|nan|inf)", text, re.M)
                results[name] = (proc.returncode, seconds, float(losses[-1]) if losses else None,
                                 text[-1500:])
            time.sleep(0.2)
    finally:
        for proc, out, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    return results


def phase_surface(torch, Transfusion, Trainer, mods):
    """Phase 4f: (a) data -> training, (b) dropout, (c) the reference
    checkpoint, (d) the example twins. Returns the launch totals of the
    in-process paths."""
    import numpy as np

    totals = dict.fromkeys(KERNELS, 0)
    surface_training(torch, Transfusion, Trainer, mods, totals)
    surface_dropout(torch, Transfusion, mods)
    surface_reference(torch, Transfusion, mods, totals)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = surface_twins()
    for name, (rc, seconds, loss, tail) in results.items():
        log(json.dumps({"surface": f"example twin {name}", "exit_code": rc, "seconds": seconds,
                        "last_loss": loss, "flags": TWINS[name]}))
    for name, (rc, seconds, loss, tail) in results.items():
        require(rc == 0, f"example twin {name} exited {rc}:\n{tail}")
        require(name == "serve_text" or (loss is not None and np.isfinite(loss)),
                f"example twin {name}: last loss {loss}\n{tail}")
    require("multimodal sample()" in results["serve_text"][3],
            "serve_text: no multimodal sample line")
    log(json.dumps({"surface": "example twins, 10 at once", "seconds": time.perf_counter() - t0}))
    return totals


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


def latent_row(rng):
    """One row of the 4k cell's shape: 5 x ([524 text][16x16x32 latent])
    and text to 4096 packed positions."""
    import numpy as np

    items = []
    for _ in range(5):
        items += [rng.integers(0, 512, 524).astype(np.int32),
                  (0, rng.standard_normal((16, 16, 32)).astype(np.float32))]
    return items + [rng.integers(0, 512, 139).astype(np.int32)]


def phase_latent_pair(torch, Transfusion, Trainer, mods):
    """Phase 5m. Returns the flash launch totals of the counted steps."""
    import numpy as np

    bf16, f32 = torch.bfloat16, torch.float32
    model = Transfusion(device="cuda", dtype=bf16, seed=0, **LATENT_CFG)
    trainer = Trainer(model, learning_rate=3e-4)
    depth = LATENT_CFG["transformer"]["depth"]
    packed = model.pack([latent_row(np.random.default_rng(i)) for i in range(8)],
                        shift_friendly=True).to_torch("cuda")
    state = trainer.init_state()
    draws = model.make_draws(packed, torch.Generator("cuda").manual_seed(0))
    wide = {"flash_fwd": lambda a: a["q"].shape[-1] == 192}
    with capturing(torch, dict(mods, layers=mods["moonlight"]), wide) as calls:
        state, _ = trainer.train_step(state, packed, draws=draws)
    torch.cuda.synchronize()
    require("flash_fwd" in calls and "do" in calls["flash_fwd"],
            "latent attention: no (192, 128) call captured")
    a = calls.pop("flash_fwd")
    require(a["v"].shape[-1] == 128 and a["q"].shape[1] == 16,
            f"latent attention: q {shape_str(a['q'])} v {shape_str(a['v'])}")
    rng = np.random.default_rng(1)
    n = 8192
    ctx = dict(q=torch.from_numpy(rng.standard_normal((1, 16, n, 192), np.float32)),
               k=torch.from_numpy(rng.standard_normal((1, 16, n, 192), np.float32)),
               v=torch.from_numpy(rng.standard_normal((1, 16, n, 128), np.float32)),
               do=torch.from_numpy(rng.standard_normal((1, 16, n, 128), np.float32)),
               spans=None, causal=True, softcap=0.0, q_offset=0, kv_offset=0,
               return_lse=False)
    ctx = {k: x.to("cuda", bf16) if isinstance(x, torch.Tensor) else x for k, x in ctx.items()}
    for what, case in ((f"main path, moonlight 4k step: q {shape_str(a['q'])} v "
                        f"{shape_str(a['v'])} spans {shape_str(a['spans'])}", a),
                       (f"b1 h16 n{n} qk192 v128 causal", ctx)):
        for dtype in (bf16, f32):
            c = {k: x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x
                 for k, x in case.items()}
            lib = dtype == bf16
            name = f"{what} {str(dtype).split('.')[-1]}"
            record("flash_fwd", name, check_flash(torch, mods, c, iters=5, library=lib,
                                                  block_q=1024), dtype)
            record("flash_bwd", name, check_flash_bwd(torch, mods, c, iters=3, library=lib,
                                                      block_q=1024), dtype)
    del calls, a, ctx
    torch.cuda.empty_cache()

    def steps(state=state):
        losses = []
        for _ in range(LATENT_STEPS):
            state, metrics = trainer.train_step(state, packed, draws=draws)
            losses.append(metrics["loss"])
        return [float(x) for x in losses]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, counts = counted(mods, steps)
    dt = time.perf_counter() - t0
    require(all(np.isfinite(losses)), f"latent attention step: non-finite loss {losses}")
    require(counts["flash_fwd"] == 2 * depth * LATENT_STEPS
            and counts["flash_bwd"] == depth * LATENT_STEPS,
            f"latent attention step: launches {counts}, want {2 * depth} forward and {depth} "
            "backward a step")
    log(json.dumps({"training": "moonlight 2 layers, 8 x 4096, remat full",
                    "steps": LATENT_STEPS, "ms_per_step": dt / LATENT_STEPS * 1e3,
                    "tokens_per_step": int(packed.total_tokens), "losses": losses,
                    "launches": counts, "by_row": {
                        "flash_fwd": mods["flash"].flash_attention.launches_by_row,
                        "flash_bwd": mods["flash"].flash_attention_backward.launches_by_row},
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    return {"flash_fwd": counts["flash_fwd"], "flash_bwd": counts["flash_bwd"]}


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
    capture = a  # phase "parallel" shards this call's sequence
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
    return {k: counts[k] for k in BY_ROW}, main, capture


# ---------------------------------------------------------------------------
# phase "parallel": context parallelism and the mesh trainer
# ---------------------------------------------------------------------------

CP_RANKS = 4


def by_row(mods):
    """The head-major wrappers' launches by TPU kernel-table row."""
    return {**mods["counters"]["flash_fwd"].launches_by_row,
            **mods["counters"]["flash_bwd"].launches_by_row}


def cp_schedule(torch, mods, a, schedule, P):
    """Each of P ranks' compute of `schedule` ('ring' or 'allgather') on
    the call `a`, one rank after another: the same `ring_local` /
    `allgather_local` the distributed path runs, the chunks a rank would
    receive sliced from the whole K / V. Forward and backward (the output
    cotangent a['do'] on the rank's rows); each rank's dk / dv partials sum
    in float32, as the ring's reverse rotation and the all-gather's
    reduce-scatter sum them. Returns (out, dq, dk, dv, chunks run,
    skipped)."""
    ctx = mods["context"]
    q, k, v, do = a["q"], a["k"], a["v"], a["do"]
    nl = q.shape[2] // P
    ctx.ring_attention.chunks.update(run=0, skipped=0)
    outs, dqs = [], []
    dk, dv = torch.zeros(k.shape, device=k.device), torch.zeros(v.shape, device=v.device)
    for r in range(P):
        q_r = q[:, :, r * nl:(r + 1) * nl].detach().requires_grad_(True)
        if schedule == "ring":
            srcs = [(r - i) % P for i in range(P)]
            ks = [k[:, :, s * nl:(s + 1) * nl].detach().requires_grad_(True) for s in srcs]
            vs = [v[:, :, s * nl:(s + 1) * nl].detach().requires_grad_(True) for s in srcs]
            out = ctx.ring_local(q_r, ks, vs, r, P, a["spans"], a["causal"], a["softcap"])
            cols = [slice(s * nl, (s + 1) * nl) for s in srcs]
        else:
            ks, vs = [k.detach().requires_grad_(True)], [v.detach().requires_grad_(True)]
            out = ctx.allgather_local(q_r, ks[0], vs[0], r, a["spans"], a["causal"],
                                      a["softcap"])
            cols = [slice(None)]
        grads = torch.autograd.grad(out, [q_r, *ks, *vs], do[:, :, r * nl:(r + 1) * nl],
                                    allow_unused=True)
        n = len(ks)
        for col, gk, gv in zip(cols, grads[1:1 + n], grads[1 + n:]):
            if gk is not None:
                dk[:, :, col] += gk.float()
                dv[:, :, col] += gv.float()
        outs.append(out.detach())
        dqs.append(grads[0])
    chunks = dict(ctx.ring_attention.chunks)
    return (torch.cat(outs, 2), torch.cat(dqs, 2), dk.to(k.dtype), dv.to(v.dtype),
            chunks["run"], chunks["skipped"])


def parallel_compute(torch, mods, a):
    """(a) each rank's compute at full width: the ring and all-gather
    schedules over CP_RANKS ranks on phase 6's captured 573M call. The
    assembled output is held against the whole-sequence kernel call
    (within 2e-2, every row within the row rule); dq / dk / dv against the
    whole-sequence backward kernel at the schedule's own output and the
    call's lse (1e-2 of the largest element, the row rule), as phase 6
    holds the kernel against its plain version at the kernel's own output:
    dq of a row whose terms cancel follows delta = rowsum(do * out), so two
    forwards that differ by bf16 rounding give such rows different
    gradients (logged: the gradients of the whole call's own backward).
    Returns ({kernel: launches by row}, log entries)."""
    fa = mods["flash"]
    q, k, v = (a[n].detach().requires_grad_(True) for n in ("q", "k", "v"))
    kw = dict(spans=a["spans"], causal=a["causal"], softcap=a["softcap"])
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    out.backward(a["do"])
    whole_grads = (q.grad, k.grad, v.grad)
    out, lse = out.detach(), lse.detach()

    def whole():
        qq, kk, vv = (a[n].detach().requires_grad_(True) for n in ("q", "k", "v"))
        fa.flash_attention(qq, kk, vv, **kw).backward(a["do"])

    whole_ms = time_ms(whole, 3)
    b, h, n, d = a["q"].shape
    entries, totals = [], {}
    for schedule in ("ring", "allgather"):
        torch.cuda.synchronize()
        (got_out, *got_grads, run, skipped), _ = counted(
            mods, lambda: cp_schedule(torch, mods, a, schedule, CP_RANKS))
        launches = by_row(mods)
        rows = {f"row {r}": c for r, c in launches.items() if c}
        err, row_rel = compare(torch, got_out, out)
        want = fa.flash_attention_backward(a["q"], a["k"], a["v"], got_out, lse, a["do"],
                                           a["spans"], a["softcap"])
        g_err, g_rel, g_row = grad_compare(torch, got_grads, want)
        w_err, w_rel, w_row = grad_compare(torch, got_grads, whole_grads)
        ms = time_ms(lambda: cp_schedule(torch, mods, a, schedule, CP_RANKS), 3)
        name = (f"{schedule}, {CP_RANKS} ranks one after another, q {shape_str(a['q'])} "
                f"spans {shape_str(a['spans'])}: nl {n // CP_RANKS}")
        entry = {"parallel": name, "fwd_err": err, "fwd_row_rel_err": row_rel,
                 "bwd_err": g_err, "bwd_rel_err": g_rel, "bwd_row_rel_err": g_row,
                 "vs_whole_call_grads": {"err": w_err, "rel_err": w_rel, "row_rel_err": w_row},
                 "launches_by_row": rows, "chunk_calls": run, "chunks_skipped": skipped,
                 "chunk_pairs": CP_RANKS * CP_RANKS if schedule == "ring" else CP_RANKS,
                 "ms_fwd_bwd_all_ranks": ms, "ms_fwd_bwd_whole_call": whole_ms}
        log(json.dumps(entry))
        entries.append(entry)
        require(err <= TOL["bfloat16"] and row_rel <= ROW_REL_TOL["bfloat16"],
                f"{name}: forward err {err}, row rule {row_rel}")
        if g_row > ROW_REL_TOL["bfloat16"]:
            diagnose_bwd_rows(torch, mods, a, got_grads, want, lse,
                              (a["do"].float() * got_out.float()).sum(-1), LONG_BLOCK_Q)
        require(g_rel <= BWD_REL_TOL["bfloat16"] and g_row <= ROW_REL_TOL["bfloat16"],
                f"{name}: backward err / max |grad| {g_rel}, row rule {g_row}")
        rows_want = (2, 8) if schedule == "ring" else (3, 9)
        require(set(launches) >= set(rows_want) and all(launches[r] > 0 for r in rows_want)
                and sum(launches.values()) == sum(launches[r] for r in rows_want),
                f"{name}: launches by row {rows}, want rows {rows_want} only")
        for r_, c in launches.items():
            totals[r_] = totals.get(r_, 0) + c
    # the kernels at the schedules' shapes against their plain versions:
    # the last rank's ring chunk from rank 0 (every pair visible) and its
    # all-gather call (flex's compile would double the phase; it is timed
    # on the whole call in phase 6)
    nl, r = n // CP_RANKS, CP_RANKS - 1
    rows = slice(r * nl, (r + 1) * nl)
    call = dict(a, q=a["q"][:, :, rows], do=a["do"][:, :, rows], q_offset=r * nl, kv_offset=0,
                return_lse=True)
    for kernel, bwd, kv, block_q, what in (
            ("flash_fwd", "flash_bwd", slice(0, nl), None, "ring chunk (rank 3, chunk 0)"),
            ("flash_fwd_streamed", "flash_bwd_streamed", slice(None), LONG_BLOCK_Q,
             "all-gather call (rank 3)")):
        c = dict(call, k=a["k"][:, :, kv], v=a["v"][:, :, kv])
        shape = (f"main path, {what} of phase 6's call: q {shape_str(c['q'])} k "
                 f"{shape_str(c['k'])} q_off {r * nl}")
        record(kernel, shape, check_flash(torch, mods, c, iters=5, block_q=block_q),
               torch.bfloat16)
        record(bwd, shape, check_flash_bwd(torch, mods, c, iters=3, block_q=block_q),
               torch.bfloat16)
    return totals, entries


def mesh_trainer(torch, Transfusion, Trainer, mods):
    """(b) `Trainer(mesh=make_mesh())` on a one-rank NCCL group: the bench
    model with attn_impl 'ring' on bench (b)'s batch (n 1024) for
    TRAIN_STEPS steps; the first step against a mesh-less flash Trainer
    step from the same weights and draws within 1e-3 relative; the route's
    forward and backward kernels once per layer per step. Returns the
    launches."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from transfusion_tpu_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh()
        name = "bench model, attn_impl 'ring', Trainer(mesh=make_mesh()) on 1 NCCL rank"
        ring_cfg = dict(BENCH_CFG, transformer=dict(BENCH_CFG["transformer"], attn_impl="ring",
                                                    mesh=mesh))
        model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **ring_cfg)
        plain = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
        trainer = Trainer(model, learning_rate=3e-4, mesh=mesh)
        depth = BENCH_CFG["transformer"]["depth"]
        rng = np.random.default_rng(0)
        packed = model.pack([bench_sample(rng, 4) for _ in range(8)], shift_friendly=True)
        require(packed.text.shape[1] == 1025, f"{name}: packed to {packed.text.shape}")
        packed = packed.to_torch("cuda")
        draws = model.make_draws(packed, torch.Generator("cuda").manual_seed(0))
        ref = Trainer(plain, learning_rate=3e-4).train_step(
            Trainer(plain).init_state(), packed, draws=draws)[1]

        def steps(state=trainer.init_state()):
            losses = []
            for _ in range(TRAIN_STEPS):
                state, metrics = trainer.train_step(state, packed, draws=draws)
                losses.append(metrics["loss"])
            return [float(x) for x in losses]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, counts = counted(mods, steps)
        dt = time.perf_counter() - t0
        rows = {f"row {r}": c for r, c in by_row(mods).items() if c}
        rel = abs(losses[0] - float(ref["loss"])) / abs(float(ref["loss"]))
        log(json.dumps({"training": name, "steps": TRAIN_STEPS, "seconds": dt,
                        "ms_per_step": dt / TRAIN_STEPS * 1e3, "loss_first": losses[0],
                        "loss_last": losses[-1], "meshless_first_loss": float(ref["loss"]),
                        "loss_rel_diff": rel, "launches": counts, "launches_by_row": rows}))
        require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"{name}: loss did not fall {losses[0]} -> {losses[-1]}")
        require(rel <= 1e-3, f"{name}: first loss {losses[0]} vs mesh-less {ref['loss']}")
        want = depth * TRAIN_STEPS
        require(counts["flash_fwd"] == want and counts["flash_bwd"] == want,
                f"{name}: launches {counts}, want {want} head-major forwards and backwards")
        return counts
    finally:
        dist.destroy_process_group()


def distributed_twin():
    """The twin of examples/train_distributed.py under torchrun, one rank on
    the card: its exit code must be 0."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=1", "-m",
                        "transfusion_tpu_torch.examples.train_distributed", "--device", "cuda",
                        "--steps", "3"], cwd=os.path.join(HERE, "build"), capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=HERE))
    log(json.dumps({"twin": "train_distributed (torchrun, 1 rank, cuda, 3 steps)",
                    "exit_code": r.returncode, "seconds": time.perf_counter() - t0,
                    "stdout_tail": r.stdout[-300:]}))
    require(r.returncode == 0, f"train_distributed twin failed:\n{r.stdout[-2000:]}"
            f"\n{r.stderr[-3000:]}")


def phase_parallel(torch, Transfusion, Trainer, mods, capture):
    """(a) each rank's compute of the ring and all-gather schedules at the
    573M shape, (b) the mesh trainer on one NCCL rank and the torchrun
    twin. Returns the launches by kernel-line entry."""
    by_row_totals, _ = parallel_compute(torch, mods, capture)
    counts = mesh_trainer(torch, Transfusion, Trainer, mods)
    distributed_twin()
    totals = {k: counts.get(k, 0) for k in KERNELS}
    for name, (wrapper, row) in BY_ROW.items():
        totals[name] += by_row_totals.get(row, 0)
    totals["flash_fwd"] += sum(c for r, c in by_row_totals.items() if r <= 3)
    totals["flash_bwd"] += sum(c for r, c in by_row_totals.items() if r >= 7)
    return totals


# ---------------------------------------------------------------------------
# phase "pipeline": pipeline parallelism, the P stages in this one process
# ---------------------------------------------------------------------------

PIPE_STAGES, PIPE_MICROBATCHES, PIPE_STEPS = 4, 8, 10
# every parameter's gradient against the unpipelined step's, as ||g - ref||
# / ||ref||: the pipelined step rounds each microbatch's weight gradient (a
# bf16 product over 4 rows, 2^-8 relative) before summing them in float32,
# the unpipelined step one product over 32 rows once; worst measured
# 0.011-0.012 (NVIDIA H100 80GB HBM3, 700.00 W), on the adaLN-zero
# gates' small gradients
PIPE_GRAD_REL_TOL = 5e-2


def pipeline_step(torch, trainer, model, state, packed, draws, pipeline):
    """One pipelined training step: `loss(pipeline=)` on the state's float32
    masters, its backward, then the Trainer's own update (fused clip + Adam
    + EMA). Returns (new state, metrics, the gradients)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in state.params.items()}
    loss, bd = model.loss(packed=packed, draws=draws, params=leaves, pipeline=pipeline,
                          return_breakdown=True)
    loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in leaves.items()}
    state, metrics = trainer._apply(state, grads, loss.detach(), trainer._loss_parts(bd),
                                    int(packed.total_tokens))
    return state, metrics, grads


def grad_rel_errs(torch, got, want):
    """{name: ||got - want|| / ||want||} over the parameters whose reference
    gradient is not zero; a zero reference must be matched exactly."""
    out = {}
    for k, w in want.items():
        wn = w.float().norm().item()
        d = (got[k].float() - w.float()).norm().item()
        out[k] = d / wn if wn > 0 else (0.0 if d == 0 else float("inf"))
    return out


def pipeline_bench(torch, Transfusion, Trainer, mods, LocalStages):
    """(a): the bench model, both schedules. Returns the launches."""
    import numpy as np

    cfg = dict(BENCH_CFG, transformer=dict(BENCH_CFG["transformer"], unet_skips=False))
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **cfg)
    trainer = Trainer(model, learning_rate=3e-4)
    depth, P, M = cfg["transformer"]["depth"], PIPE_STAGES, PIPE_MICROBATCHES
    rng = np.random.default_rng(0)
    packed = model.pack([bench_sample(rng, 1) for _ in range(32)], shift_friendly=True)
    require(packed.text.shape[1] == 257, f"pipeline bench: packed to {packed.text.shape}")
    packed = packed.to_torch("cuda")
    draws = model.make_draws(packed, torch.Generator("cuda").manual_seed(0))
    state0 = trainer.init_state()
    (ref_loss, _, ref_grads), ref_counts = counted(
        mods, lambda: trainer._grads(state0, packed, draws))
    ref_loss = float(ref_loss)
    require(ref_counts["flash_fwd_nhd"] == depth and ref_counts["flash_bwd_nhd"] == depth,
            f"pipeline bench: the unpipelined step launched {ref_counts}")
    totals = dict.fromkeys(KERNELS, 0)
    for schedule, fwd_per_layer in (("gpipe", 1), ("1f1b", 2)):
        name = (f"bench model, unet_skips=False, 32 x n 256, {P} stages of {depth // P} layers "
                f"in one process, M {M} of {32 // M} rows, {schedule}")
        pipeline = (LocalStages(P), M, schedule)

        def steps(pipeline=pipeline):
            """The steps; the first also keeps a copy of one stage's
            token-major call that takes part in the backward."""
            state, losses, first, seconds = state0, [], None, []
            for i in range(PIPE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (capturing(torch, mods, {"flash_fwd_nhd": lambda a: torch.is_grad_enabled()})
                      if i == 0 else contextlib.nullcontext()) as seen:
                    state, metrics, grads = pipeline_step(torch, trainer, model, state, packed,
                                                          draws, pipeline)
                if i == 0:
                    calls.update(seen)
                losses.append(metrics["loss"])
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                if first is None:
                    first = grads
            return [float(x) for x in losses], first, seconds

        calls = {}
        (losses, first, seconds), counts = counted(mods, steps)
        errs = grad_rel_errs(torch, first, ref_grads)
        worst = max(errs, key=errs.get)
        rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        per_step = {k: c / PIPE_STEPS for k, c in counts.items() if c}
        log(json.dumps({
            "pipeline": name, "steps": PIPE_STEPS, "seconds": sum(seconds),
            "first_step_ms": seconds[0] * 1e3,
            "ms_per_step_after_first": float(np.median(seconds[1:])) * 1e3,
            "loss_first": losses[0],
            "loss_last": losses[-1], "unpipelined_first_loss": ref_loss, "loss_rel_diff": rel,
            "grad_rel_err_max": errs[worst], "grad_rel_err_worst_param": worst,
            "grad_rel_err_median": float(np.median(list(errs.values()))),
            "launches_per_step_by_row": {"row 5": per_step.get("flash_fwd_nhd", 0),
                                         "row 6": per_step.get("flash_bwd_nhd", 0)},
            "launches": counts}))
        require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        require(rel <= 1e-3, f"{name}: first loss {losses[0]} vs unpipelined {ref_loss}")
        require(errs[worst] <= PIPE_GRAD_REL_TOL,
                f"{name}: gradient of {worst} {errs[worst]} from the unpipelined one")
        require(losses[-1] < losses[0], f"{name}: loss did not fall {losses[0]} -> {losses[-1]}")
        want_f, want_b = fwd_per_layer * depth * M * PIPE_STEPS, depth * M * PIPE_STEPS
        require(counts["flash_fwd_nhd"] == want_f and counts["flash_bwd_nhd"] == want_b
                and sum(counts.values()) == want_f + want_b,
                f"{name}: launches {counts}, want {want_f} of row 5 and {want_b} of row 6")
        require("do" in calls.get("flash_fwd_nhd", {}), f"{name}: no stage's call captured")
        a = calls.pop("flash_fwd_nhd")
        shape = (f"main path, pipeline, {name}: a stage's call q {shape_str(a['q'])} "
                 f"rope spans {shape_str(a['spans'])}")
        f_res, b_res = check_nhd(torch, mods, a)
        record("flash_fwd_nhd", shape, f_res, torch.bfloat16)
        record("flash_bwd_nhd", shape, b_res, torch.bfloat16)
        del a
        for k in totals:
            totals[k] += counts[k]
    return totals


def row_draws(whole, draws, pack, b: int):
    """The draws of row b of `whole` for `pack`, the same sample packed
    alone: its times and CFG uniform, and its instances' noise in the
    order of pack's groups."""
    import dataclasses

    noises = []
    for gp in pack.groups:
        gi = next(i for i, g in enumerate(whole.groups) if g.modality_type == gp.modality_type
                  and tuple(g.seq_shape) == tuple(gp.seq_shape))
        g = whole.groups[gi]
        idx = [int(((g.batch_idx == b) & (g.span_rows == s)).nonzero()[0, 0])
               for s in gp.span_rows.tolist()]
        noises.append(draws.noises[gi][idx])
    return dataclasses.replace(draws, times=draws.times[b:b + 1],
                               cfg_uniform=draws.cfg_uniform[b:b + 1], noises=tuple(noises))


def pipeline_long(torch, Transfusion, Trainer, mods, LocalStages):
    """(b): the 573M config at 4 x n 16384, 1F1B. Returns the launches."""
    import numpy as np

    P, M = PIPE_STAGES, 4
    cfg = dict(LONG_CFG, transformer=dict(LONG_CFG["transformer"], unet_skips=False))
    depth = cfg["transformer"]["depth"]
    name = (f"573M, unet_skips=False, 4 x n 16384, {P} stages of {depth // P} layers in one "
            f"process, M {M}, 1f1b, remat full, ce_chunk 256")
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **cfg)
    rng = np.random.default_rng(0)
    samples = [long_sample(rng) for _ in range(M)]
    whole = model.pack(samples, shift_friendly=True)
    require(whole.text.shape == (M, LONG_N), f"{name}: packed to {whole.text.shape}")
    whole = whole.to_torch("cuda")
    packs = [model.pack([s], shift_friendly=True).to_torch("cuda") for s in samples]
    draws = model.make_draws(whole, torch.Generator("cuda").manual_seed(0))
    accum = Trainer(model, learning_rate=3e-4, grad_accumulation=M)
    state = accum.init_state()
    t0 = time.perf_counter()
    ref = accum.train_step(state, packs, draws=[row_draws(whole, draws, p, b)
                                                for b, p in enumerate(packs)])[1]
    ref_loss, ref_s = float(ref["loss"]), time.perf_counter() - t0  # the model's first step
    del accum, ref
    torch.cuda.empty_cache()

    trainer = Trainer(model, learning_rate=3e-4)
    pipeline = (LocalStages(P), M, "1f1b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with capturing(torch, mods, {"flash_fwd": lambda a: torch.is_grad_enabled()}) as calls:
        (_, metrics, _), counts = counted(mods, lambda: pipeline_step(
            torch, trainer, model, state, whole, draws, pipeline))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    rel = abs(loss - ref_loss) / abs(ref_loss)
    log(json.dumps({
        "pipeline": name, "seconds_step": dt, "loss": loss,
        "grad_accumulation_4_loss": ref_loss, "grad_accumulation_4_first_step_seconds": ref_s,
        "loss_rel_diff": rel, "peak_memory_gb_all_stages_one_process": peak / 1e9,
        "launches_by_row": {"row 3": counts["flash_fwd_streamed"],
                            "row 9": counts["flash_bwd_streamed"]}, "launches": counts}))
    require(np.isfinite(loss), f"{name}: non-finite loss {loss}")
    require(rel <= 1e-3, f"{name}: loss {loss} vs Trainer(grad_accumulation=4) {ref_loss}")
    want_f, want_b = 3 * depth * M, depth * M
    require(counts["flash_fwd_streamed"] == counts["flash_fwd"] == want_f
            and counts["flash_bwd_streamed"] == counts["flash_bwd"] == want_b
            and sum(counts.values()) == 2 * (want_f + want_b),
            f"{name}: launches {counts}, want {want_f} streamed forwards and {want_b} "
            "streamed backwards and no other")
    require("flash_fwd" in calls and "do" in calls["flash_fwd"],
            f"{name}: no stage's attention call captured")
    a = calls.pop("flash_fwd")
    shape = (f"main path, {name}: a stage's call q {shape_str(a['q'])} spans "
             f"{shape_str(a['spans'])}, plain in blocks of {LONG_BLOCK_Q} rows")
    record("flash_fwd_streamed", shape, check_flash(torch, mods, a, iters=3,
                                                    block_q=LONG_BLOCK_Q), torch.bfloat16)
    record("flash_bwd_streamed", shape, check_flash_bwd(torch, mods, a, iters=3,
                                                        block_q=LONG_BLOCK_Q), torch.bfloat16)
    return {k: counts[k] for k in KERNELS}


def phase_pipeline(torch, Transfusion, Trainer, mods):
    """(a) the bench model on both schedules, (b) the 573M config on 1F1B,
    P stages in this process. Returns the launches by kernel-line entry."""
    from transfusion_tpu_torch.parallel import LocalStages

    totals = pipeline_bench(torch, Transfusion, Trainer, mods, LocalStages)
    torch.cuda.empty_cache()
    for k, c in pipeline_long(torch, Transfusion, Trainer, mods, LocalStages).items():
        totals[k] += c
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase "sharded optimizer": a custom chain on fsdp 2 x tensor 2, 4 ranks on one card
# ---------------------------------------------------------------------------

SHARD_RANKS, SHARD_MESH, SHARD_STEPS = 4, dict(fsdp=2, tensor=2), 5
SHARD_TIMEOUT_S = 300  # a rank that waits this long in a collective fails the phase
# the new parameters' non-Muon entries (Adam-atan2) against the mesh-less
# step: each within 1e-3; at the first step atan2(g, |g|) is the gradient's
# sign, so an entry whose ~0 gradient takes its sign from rounding steps 2
# lr the other way: at most this share of the entries may differ past 1e-5
# (a wrong gradient would flip about half of them)
SHARD_FLIP_SHARE = 0.05


def sharded_chain():
    """`examples/train_image_only.py`'s chain: the clip inside it."""
    from transfusion_tpu_torch.training import optim

    return optim.chain(optim.clip_by_global_norm(0.5), optim.muon_adam_atan2(3e-4, 3e-4))


def sharded_inputs(torch, model):
    """Bench (a)'s batch (32 x n 256) and draws."""
    import numpy as np

    rng = np.random.default_rng(0)
    packed = model.pack([bench_sample(rng, 1) for _ in range(32)], shift_friendly=True)
    require(packed.text.shape[1] == 257, f"sharded optimizer: packed to {packed.text.shape}")
    packed = packed.to_torch("cuda")
    return packed, model.make_draws(packed, torch.Generator("cuda").manual_seed(0))


def sharded_reference(torch, Transfusion, Trainer, path):
    """One step of a mesh-less Trainer with the same chain, weights and
    draws, written to `path` for the ranks: the loss, grad_norm, the
    masters before and after, and the names of the Muon matrices."""
    from transfusion_tpu_torch.training import optim

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    trainer = Trainer(model, optimizer=sharded_chain(), grad_clip_norm=None)
    packed, draws = sharded_inputs(torch, model)
    state = trainer.init_state()
    new, metrics = trainer.train_step(state, packed, draws=draws)
    torch.save({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "before": state.params, "after": new.params,
                "muon": sorted(k for k, m in optim.muon_param_mask(state.params).items() if m)},
               path)


def trees_equal(torch, a, b) -> bool:
    """Two states (dicts, tuples, tensors, ints) equal exactly."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            trees_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            trees_equal(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(a, b)
    return a == b


def sharded_rank(rank, port, out_dir):
    """One of SHARD_RANKS processes of a gloo group, every one on device 0:
    `Trainer(mesh=make_mesh(fsdp=2, tensor=2), optimizer=sharded_chain(),
    grad_clip_norm=None)` for SHARD_STEPS steps on bench (a), its launches
    counted; step 1 held against the mesh-less reference; a save on every
    rank and a restore by a new Trainer. Writes its results to
    out_dir/rank<rank>.pt and, on rank 0, the first captured attention
    call to out_dir/call.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    Transfusion, Trainer, mods = port_modules()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=SHARD_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        from transfusion_tpu_torch.parallel import make_mesh
        from transfusion_tpu_torch.parallel.mesh import shard_tensor

        mesh = make_mesh(**SHARD_MESH, device="cuda")
        model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
        ck = os.path.join(out_dir, "checkpoint")
        trainer = Trainer(model, optimizer=sharded_chain(), grad_clip_norm=None, mesh=mesh,
                          checkpoint_dir=ck)
        packed, draws = sharded_inputs(torch, model)
        ref = torch.load(os.path.join(out_dir, "reference.pt"), map_location="cuda",
                         weights_only=True)
        update_s, apply = [], trainer._apply

        def timed_apply(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = apply(*a, **k)
            torch.cuda.synchronize()
            update_s.append(time.perf_counter() - t)
            return out

        trainer._apply = timed_apply
        state0 = trainer.init_state()

        def steps():
            state, losses, norms, seconds, first, calls = state0, [], [], [], None, {}
            for i in range(SHARD_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with (capturing(torch, mods, {"flash_fwd_nhd": lambda a: True,
                                              "flash_fwd": lambda a: True})
                      if i == 0 and rank == 0 else contextlib.nullcontext()) as seen:
                    state, metrics = trainer.train_step(state, packed, draws=draws)
                    losses.append(float(metrics["loss"]))
                    norms.append(float(metrics["grad_norm"]))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
                if i == 0:
                    first, calls = state, dict(seen or {})
            return state, losses, norms, seconds, first, calls

        (state, losses, norms, seconds, first, calls), counts = counted(mods, steps)
        if rank == 0:
            require(calls, "sharded optimizer: no attention call captured")
            torch.save(calls, os.path.join(out_dir, "call.pt"))
        del calls

        # step 1 against the mesh-less Trainer, shard by shard
        def shard(k, v):
            return shard_tensor(k, v, trainer._specs[k], trainer._axes)

        require(all(torch.equal(state0.params[k], shard(k, v)) for k, v in ref["before"].items()),
                "sharded optimizer: the initial shards are not the mesh-less masters'")
        muon_share, adam_abs, flips, total = 0.0, 0.0, 0, 0
        for k, w in ref["after"].items():
            diff = first.params[k] - shard(k, w)
            if k in ref["muon"]:
                step = (shard(k, w) - shard(k, ref["before"][k])).norm().item()
                muon_share = max(muon_share, diff.norm().item() / max(step, 1e-30))
            else:
                adam_abs = max(adam_abs, diff.abs().max().item())
                flips += int((diff.abs() > 1e-5).sum())
                total += diff.numel()

        trainer.save(state)
        restored = Trainer(model, optimizer=sharded_chain(), grad_clip_norm=None, mesh=mesh,
                           checkpoint_dir=ck).restore()
        restored_equal = {
            "params": trees_equal(torch, restored.params, state.params),
            "ema": trees_equal(torch, restored.ema.params, state.ema.params)
            and restored.ema.step == state.ema.step,
            "opt_state": trees_equal(torch, restored.opt_state, state.opt_state),
            "step": restored.step == state.step}
        dist.barrier()
        torch.save({
            "losses": losses, "grad_norms": norms, "seconds": seconds,
            "update_ms": [s * 1e3 for s in update_s], "counts": counts,
            "loss_rel": abs(losses[0] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm_rel": abs(norms[0] - ref["grad_norm"]) / abs(ref["grad_norm"]),
            "muon_share": muon_share, "adam_max_abs": adam_abs, "adam_flips": flips,
            "adam_entries": total, "restored_equal": restored_equal,
            "shard_shapes": {k: tuple(v.shape) for k, v in state.params.items()},
        }, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_sharded_optimizer(torch, Transfusion, Trainer, mods):
    """A custom optimizer chain on a mesh that shards parameters, 4 gloo
    ranks on the one card (NCCL takes one rank per device): the bench model
    at full width (8 heads of 64: 4 a rank) under `Trainer(mesh=make_mesh(
    fsdp=2, tensor=2), optimizer=chain(clip_by_global_norm(0.5),
    muon_adam_atan2(3e-4, 3e-4)), grad_clip_norm=None)` for SHARD_STEPS
    steps on bench (a): every rank reports the same losses, which fall; the
    first loss and grad_norm within 1e-3 relative of a mesh-less Trainer's
    with the same chain, weights and draws; after step 1 every rank's
    shards beside that Trainer's new masters (Muon matrices within
    MUON_REL_TOL of its step's Frobenius norm; the rest within 1e-3, at most
    SHARD_FLIP_SHARE of them past 1e-5); the route's forward and backward
    rows launched once per layer, step and rank; one captured call on the 4
    heads held against the plain versions; a save on every rank and a
    restore by a new Trainer give back every shard of the params, the EMA
    and the optimizer state exactly. Returns the launches."""
    import socket

    import numpy as np
    import torch.multiprocessing as mp

    out_dir = os.path.join(HERE, "build", "sharded_optimizer")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    sharded_reference(torch, Transfusion, Trainer, os.path.join(out_dir, "reference.pt"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    try:
        mp.start_processes(sharded_rank, args=(port, out_dir),
                           nprocs=SHARD_RANKS, join=True, start_method="spawn")
    except mp.ProcessRaisedException as e:
        raise SmokeFailure(f"sharded optimizer: a rank failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise SmokeFailure(f"sharded optimizer: a rank exited: {e}") from None
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(SHARD_RANKS)]
    depth = BENCH_CFG["transformer"]["depth"]
    name = (f"bench model, fsdp 2 x tensor 2, {SHARD_RANKS} gloo ranks on one card, "
            "chain(clip 0.5, muon_adam_atan2(3e-4, 3e-4))")
    route = "flash_fwd_nhd" if ranks[0]["counts"]["flash_fwd_nhd"] else "flash_fwd"
    bwd = {"flash_fwd_nhd": "flash_bwd_nhd", "flash_fwd": "flash_bwd"}[route]
    log(json.dumps({
        "sharded_optimizer": name, "steps": SHARD_STEPS, "reference_seconds": ref_s,
        "ranks_seconds": ranks_s,
        "route": "token-major, rows 5 / 6" if route == "flash_fwd_nhd" else "head-major",
        "loss": ranks[0]["losses"], "grad_norm": ranks[0]["grad_norms"],
        "loss_rel_vs_meshless": ranks[0]["loss_rel"],
        "grad_norm_rel_vs_meshless": ranks[0]["grad_norm_rel"],
        "note": f"{SHARD_RANKS} ranks share one card: ms a step is no per-card rate",
        "ms_per_step_after_first_by_rank": [
            float(np.median(r["seconds"][1:])) * 1e3 for r in ranks],
        "update_ms_after_first_by_rank": [float(np.median(r["update_ms"][1:])) for r in ranks],
        "muon_share_max": max(r["muon_share"] for r in ranks),
        "adam_max_abs": max(r["adam_max_abs"] for r in ranks),
        "adam_flip_share": sum(r["adam_flips"] for r in ranks)
        / sum(r["adam_entries"] for r in ranks),
        "launches_by_rank": [{k: c for k, c in r["counts"].items() if c} for r in ranks],
        "restored_equal": ranks[0]["restored_equal"],
        "shard_shapes_rank0": {k: v for k, v in ranks[0]["shard_shapes"].items()
                               if k.startswith(("transformer.blocks.0.", "text_embed"))}}))
    for r, res in enumerate(ranks):
        what = f"{name}, rank {r}"
        require(res["losses"] == ranks[0]["losses"], f"{what}: losses {res['losses']} differ "
                f"from rank 0's {ranks[0]['losses']}")
        require(all(np.isfinite(res["losses"])), f"{what}: non-finite loss {res['losses']}")
        require(res["losses"][-1] < res["losses"][0], f"{what}: loss did not fall")
        require(res["loss_rel"] <= 1e-3 and res["grad_norm_rel"] <= 1e-3,
                f"{what}: first loss / grad_norm {res['loss_rel']} / {res['grad_norm_rel']} "
                "relative from the mesh-less step")
        require(res["muon_share"] <= MUON_REL_TOL,
                f"{what}: a Muon matrix {res['muon_share']} of its step from the mesh-less one")
        require(res["adam_max_abs"] <= 1e-3
                and res["adam_flips"] <= SHARD_FLIP_SHARE * res["adam_entries"],
                f"{what}: Adam-atan2 entries {res['adam_max_abs']} max, {res['adam_flips']} of "
                f"{res['adam_entries']} past 1e-5")
        require(all(res["restored_equal"].values()), f"{what}: restored {res['restored_equal']}")
        want = depth * SHARD_STEPS
        counts = res["counts"]
        require(counts[route] == want and counts[bwd] == want
                and sum(counts.values()) == 2 * want,
                f"{what}: launches {counts}, want {want} of {route} and of {bwd} only")
    a = torch.load(os.path.join(out_dir, "call.pt"), map_location="cuda", weights_only=False)
    a = a[route]
    require("do" in a, f"{name}: the captured call has no cotangent")
    shape = (f"main path, sharded optimizer, {name}: rank 0's call q {shape_str(a['q'])} "
             f"spans {shape_str(a['spans'])}")
    if route == "flash_fwd_nhd":
        f_res, b_res = check_nhd(torch, mods, a)
    else:
        f_res, b_res = check_flash(torch, mods, a, iters=5), check_flash_bwd(torch, mods, a)
    record(route, shape, f_res, torch.bfloat16)
    record(bwd, shape, b_res, torch.bfloat16)
    totals = dict.fromkeys(KERNELS, 0)
    for res in ranks:
        for k in totals:
            totals[k] += res["counts"][k]
    return totals


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


def port_modules():
    """(Transfusion, Trainer, mods): the port's entry points and the
    modules the phases reach into, `mods['counters']` the kernel wrappers
    whose launch counters the phases read. Raises ImportError outside a
    checkout of the repository."""
    sys.path.insert(0, HERE)
    from transfusion_tpu_torch import Transfusion
    from transfusion_tpu_torch.models import (
        engine,
        engine_mm,
        layers,
        modality_io,
        moonlight,
        sample_batch,
        serving,
        transfusion,
    )
    from transfusion_tpu_torch.ops import decode_attn, flash_attn, flash_attn_nhd, rope, spans
    from transfusion_tpu_torch.parallel import context
    from transfusion_tpu_torch.training import Trainer

    counters = {
        "flash_fwd": flash_attn.flash_attention,
        "flash_bwd": flash_attn.flash_attention_backward,
        "flash_fwd_nhd": flash_attn_nhd.flash_attention_nhd,
        "flash_bwd_nhd": flash_attn_nhd.flash_attention_nhd_backward,
        "decode_attn": decode_attn.decode_attention,
    }
    mods = dict(flash=flash_attn, nhd=flash_attn_nhd, decode=decode_attn, layers=layers,
                spans=spans, rope=rope, transfusion=transfusion, sample_batch=sample_batch,
                engine=engine, engine_mm=engine_mm, serving=serving, modality_io=modality_io,
                context=context, moonlight=moonlight, counters=counters)
    return Transfusion, Trainer, mods


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        Transfusion, Trainer, mods = port_modules()
        from transfusion_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
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
    timed_phase(phase_reference, torch, Transfusion, mods)
    timed_phase(phase_reference_training, torch, Transfusion, Trainer, mods)
    launches, main_path = timed_phase(phase_serving, torch, Transfusion, mods)
    sampling_launches = timed_phase(phase_sampling, torch, Transfusion, mods)
    engine_launches = timed_phase(phase_engines, torch, Transfusion, mods)
    image_launches = timed_phase(phase_image, torch, Transfusion, Trainer, mods)
    recipe_launches = timed_phase(phase_recipes, torch, Transfusion, Trainer, mods)
    surface_launches = timed_phase(phase_surface, torch, Transfusion, Trainer, mods)
    train_launches, train_path = timed_phase(phase_training, torch, Transfusion, Trainer, mods)
    latent_launches = timed_phase(phase_latent_pair, torch, Transfusion, Trainer, mods)
    long_launches, long_path, capture = timed_phase(phase_long_training, torch, Transfusion,
                                                    Trainer, mods)
    parallel_launches = timed_phase(phase_parallel, torch, Transfusion, Trainer, mods, capture)
    del capture
    pipeline_launches = timed_phase(phase_pipeline, torch, Transfusion, Trainer, mods)
    sharded_launches = timed_phase(phase_sharded_optimizer, torch, Transfusion, Trainer, mods)

    # the kernels line: launches over the serving and training runs (the
    # streamed entries: over the long-context run); times on the tensors
    # captured from the text path with bf16 KV (flash_fwd, decode_attn),
    # from the training runs (the backward and token-major kernels) and from
    # the long-context run (the streamed entries)
    timed = {**train_path, **main_path["generate_text_batch bf16 KV"], **long_path}
    kernels = []
    for name, meta in KERNELS.items():
        total = (launches.get(name, 0) + sampling_launches.get(name, 0)
                 + engine_launches.get(name, 0) + image_launches.get(name, 0)
                 + recipe_launches.get(name, 0) + surface_launches.get(name, 0)
                 + train_launches.get(name, 0) + latent_launches.get(name, 0)
                 + long_launches.get(name, 0)
                 + parallel_launches.get(name, 0) + pipeline_launches.get(name, 0)
                 + sharded_launches.get(name, 0))
        require(total > 0, f"{name} was not launched on the main paths")
        m = timed[name]
        kernels.append(dict(
            name=name, route="cuda", **meta, launches=total,
            max_abs_err=max(r["err"] for r in RESULTS[name]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m.get("library_ms"),
        ))
    log(smi)  # again, so that the card stands beside the numbers in the output's tail
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
