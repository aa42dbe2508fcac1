#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path on one GPU.

    python3 scripts/torch_serving_profile.py

Runs the bench model at full width (dim 384, depth 8, 8x64 heads, bf16,
seeded weights) through four windows under `torch.profiler`:

  * text: `generate_text_batch` on 8 ragged prompts (lengths 37..900),
    32 new tokens, greedy;
  * image: `sample(cache_kv=True)` with CFG 3.0, 16 midpoint steps, 14x14;
  * uncached image: `sample()` (cache_kv=False) on the same prompt, 16 text
    tokens after the image;
  * batched: `sample_batch` over 8 requests (4 prompts of 24-200 text
    tokens ending in [som], 4 of 16-900 text tokens; 16 pool rows), CFG
    3.0, 196 + 32 tokens each, text chunks of 32, greedy;
  * text engine: `ServingEngine.run` (8 rows, chunks up to 64, greedy,
    after `warmup(fit_cap_slope=True)`) over `chip_smoke.py` phase 4c's
    queue of 24 requests (16-900 prompt tokens; 16 budgets of 16-64 new
    tokens, 8 of 128-256);
  * multimodal engine: `MultimodalServingEngine.run` (4 requests, 8 pool
    rows, CFG 3.0, 16 midpoint steps, 14x14, chunks up to 32, after
    `warmup()`) over the batched window's 8 requests;

then the 573M config of `scripts/probe_573m.py` (dim 1024, depth 12, 16x64
heads, vocab 50k, bf16, seeded weights) through one window:

  * long text: `generate_text_batch` on 8 ragged prompts of 850-8192 tokens
    (width 8192, cache capacity 8320), 32 new tokens, greedy, bf16 KV, as
    `chip_smoke.py` phase 4 runs it.

For each window it prints one JSON line: wall seconds, summed device
kernel time, the device's busy share (kernel time / wall; an upper bound,
since overlapping kernels would count twice — the port uses one stream),
the number of kernel launches, and the ten kernels with the most device
time. Then one line of launches per call, each counted by the profiler
over one call captured from the windows' warm-ups: a `sample_batch` text
chunk (per tick), one flow evaluation of its grouped ODE, and one of the
uncached sampler's ODE; and one of each engine's decode chunks (per step).
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_CFG = dict(
    num_text_tokens=256, dim_latent=32, modality_default_shape=(14, 14),
    transformer=dict(dim=384, depth=8, dim_head=64, heads=8, attn_impl="flash"),
)
# scripts/probe_573m.py:29-41, as chip_smoke.py's LONG_CFG (its training
# options do not act when serving)
LONG_CFG = dict(
    num_text_tokens=50_000, dim_latent=32, modality_default_shape=(14, 14), pad_multiple=64,
    ce_chunk_size=256,
    transformer=dict(dim=1024, depth=12, dim_head=64, heads=16, attn_impl="flash",
                     remat=True, remat_policy="full"),
)
LONG_PROMPTS = (8192, 7150, 6100, 5050, 4000, 2950, 1900, 850)
BATCH_IMAGE_TEXT = (24, 81, 143, 200)  # chip_smoke.py's sample_batch requests
BATCH_TEXT = (16, 311, 605, 900)


def profile(torch, name, fn):
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time / 1e3  # ms
            k[1] += 1
            launches += 1
    device_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "window": name, "wall_s": wall, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / wall, "kernel_launches": launches,
        "top_kernels": [{"name": n[:90], "ms": v[0], "calls": v[1]} for n, v in top],
    }), flush=True)


def launches_of(torch, fn, attempts=3):
    """Device kernels one call of fn launches: the most seen over a few
    profiled calls (the profiler now and then drops events)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(attempts):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(ev.device_type == torch.autograd.DeviceType.CUDA
                             for ev in prof.events()))
    return best


class FirstCall:
    """Keeps the arguments of the first call of module.attr that `accept`
    takes, while the call goes on unchanged."""

    def __init__(self, module, attr, accept=lambda *a, **k: True):
        self.module, self.attr, self.accept = module, attr, accept
        self.orig, self.args = getattr(module, attr), None

    def __enter__(self):
        def spy(*args, **kw):
            if self.args is None and self.accept(*args, **kw):
                self.args = (args, kw)
            return self.orig(*args, **kw)

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from transfusion_tpu_torch import Transfusion

    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in (37, 160, 283, 406, 530, 653, 776, 900)]
    profile(torch, "generate_text_batch b8 32 new tokens", lambda: model.generate_text_batch(
        prompts, max_new_tokens=32, temperature=0.0))
    prompt = [np.asarray(list(rng.integers(0, 256, size=24)) + [model.som_ids[0]], np.int32)]
    profile(torch, "sample cache_kv cfg 3.0 one 14x14 image", lambda: model.sample(
        prompt=prompt, max_length=196, text_temperature=0.0, cache_kv=True, cfg_scale=3.0,
        modality_steps=16, fixed_modality_shape=(14, 14)))

    from transfusion_tpu_torch.models import sample_batch as sb
    from transfusion_tpu_torch.models import transfusion as tf

    with FirstCall(tf, "odeint") as uncached_ode:
        profile(torch, "sample uncached cfg 3.0 one 14x14 image, 16 text tokens after it",
                lambda: model.sample(prompt=prompt, max_length=196 + 16, text_temperature=0.0,
                                     cfg_scale=3.0, modality_steps=16,
                                     fixed_modality_shape=(14, 14)))
    prompts = ([[np.asarray(list(rng.integers(0, 256, n)) + [model.som_ids[0]])]
                for n in BATCH_IMAGE_TEXT] + [[rng.integers(0, 256, n)] for n in BATCH_TEXT])
    with FirstCall(sb, "_chunk_tick_impl", lambda *a, **k: k["k"] == 32) as chunk, \
            FirstCall(sb, "odeint") as pooled_ode:
        profile(torch, "sample_batch R 8 (16 pool rows) cfg 3.0, 196 + 32 tokens each",
                lambda: model.sample_batch(prompts, max_length=196 + 32, text_chunk=32,
                                           text_temperature=0.0, cfg_scale=3.0,
                                           modality_steps=16, fixed_modality_shape=(14, 14)))
    per_call = {}
    (args, kw) = chunk.args
    per_call["sample_batch text tick"] = launches_of(
        torch, lambda: sb._chunk_tick_impl(*args, **kw)) / kw["k"]
    for name, cap in (("sample_batch ODE evaluation, 16 rows", pooled_ode),
                      ("uncached sample ODE evaluation", uncached_ode)):
        (flow, y0, grid), _ = cap.args
        per_call[name] = launches_of(torch, lambda: flow(grid[0], y0))
    print(json.dumps({"launches_per_call": per_call}), flush=True)

    from chip_smoke import engine_text_workload
    from transfusion_tpu_torch.models.engine import ServingEngine
    from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine

    t_prompts, budgets = engine_text_workload(np.random.default_rng(3))
    eng = ServingEngine.for_workload(model, t_prompts, budgets, max_batch=8, decode_chunk=64,
                                     temperature=0.0)
    eng.warmup(fit_cap_slope=True)

    def serve_queue(engine, queue):
        for p, b in queue:
            engine.submit(p, b)
        return engine.run()

    from transfusion_tpu_torch.models import engine as engine_mod

    with FirstCall(engine_mod.DecodeGraph, "chunk", lambda *a, **k: k["k"] >= 8) as text_chunk:
        profile(torch, "ServingEngine 8 rows, 24 requests (16-900 prompt tokens, 16-256 new)",
                lambda: serve_queue(eng, list(zip(t_prompts, budgets))))
    mm = MultimodalServingEngine.for_workload(
        model, prompts, 196 + 32, max_requests=4, cfg_scale=3.0, modality_steps=16,
        fixed_modality_shape=(14, 14), text_chunk=32, text_temperature=0.0, kv_quantize=False)
    mm.warmup()
    with FirstCall(sb, "_chunk_tick_impl", lambda *a, **k: k["k"] >= 8) as mm_chunk:
        profile(torch, "MultimodalServingEngine 4 requests (8 pool rows), 8 requests, 196 + 32 "
                "tokens each", lambda: serve_queue(mm, [(p, 196 + 32) for p in prompts]))
    per_call = {}
    for name, cap, fn in (("ServingEngine decode step (graph replay), 8 rows", text_chunk,
                           engine_mod.DecodeGraph.chunk),
                          ("MultimodalServingEngine text tick, 8 rows", mm_chunk,
                           sb._chunk_tick_impl)):
        (args, kw) = cap.args
        per_call[name] = launches_of(torch, lambda: fn(*args, **kw)) / kw["k"]
    print(json.dumps({"launches_per_call": per_call}), flush=True)
    del model, eng, mm
    torch.cuda.empty_cache()
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **LONG_CFG)
    prompts = [rng.integers(0, 50_000, size=n) for n in LONG_PROMPTS]
    profile(torch, "573M generate_text_batch b8 prompts 850-8192 32 new tokens bf16 KV",
            lambda: model.generate_text_batch(prompts, max_new_tokens=32, temperature=0.0,
                                              kv_quantize=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
