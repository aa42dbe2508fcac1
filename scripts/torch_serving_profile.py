#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path on one GPU.

    python3 scripts/torch_serving_profile.py

Runs the bench model at full width (dim 384, depth 8, 8x64 heads, bf16,
seeded weights) through two windows under `torch.profiler`:

  * text: `generate_text_batch` on 8 ragged prompts (lengths 37..900),
    32 new tokens, greedy;
  * image: `sample(cache_kv=True)` with CFG 3.0, 16 midpoint steps, 14x14;

then the 573M config of `scripts/probe_573m.py` (dim 1024, depth 12, 16x64
heads, vocab 50k, bf16, seeded weights) through one window:

  * long text: `generate_text_batch` on 8 ragged prompts of 850-8192 tokens
    (width 8192, cache capacity 8320), 32 new tokens, greedy, bf16 KV, as
    `chip_smoke.py` phase 4 runs it.

For each window it prints one JSON line: wall seconds, summed device
kernel time, the device's busy share (kernel time / wall; an upper bound,
since overlapping kernels would count twice — the port uses one stream),
the number of kernel launches, and the ten kernels with the most device
time. Needs a CUDA device.
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
    del model
    torch.cuda.empty_cache()
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **LONG_CFG)
    prompts = [rng.integers(0, 50_000, size=n) for n in LONG_PROMPTS]
    profile(torch, "573M generate_text_batch b8 prompts 850-8192 32 new tokens bf16 KV",
            lambda: model.generate_text_batch(prompts, max_new_tokens=32, temperature=0.0,
                                              kv_quantize=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
