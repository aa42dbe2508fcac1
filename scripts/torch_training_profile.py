#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step on one GPU.

    python3 scripts/torch_training_profile.py

Builds the bench model at full width (dim 384, depth 8, 8x64 heads, bf16
compute over float32 master weights, seeded weights) and profiles one
`Trainer.train_step` (pack excluded: the batch is packed and on the card)
under `torch.profiler` for each attention route:

  * token-major: `bench.py`'s batch, 32 x [32 text][14x14x32 latent][8 text],
    n 256 after the shift;
  * head-major: 8 samples of four such groups, n 1024 after the shift.

Then the long-context window of `chip_smoke.py` phase 6: the 573M config
of `scripts/probe_573m.py` (dim 1024, depth 12, 16x64 heads, vocab 50k,
remat 'full', ce_chunk_size 256) with `Trainer(grad_accumulation=2)` on 2
samples packed to n 16384 each, under remat 'full', 'dots' and none; for
each, the peak device memory (`torch.cuda.max_memory_allocated`) of one
microbatch's forward and backward above what stays resident, and of a
whole step.

For each profiled window it prints one JSON line: wall seconds of the
profiled step (the profiler adds host time, so the busy share is a lower
bound of the unprofiled step's), summed device kernel time, the device's
busy share (kernel time / wall; the port runs one stream), the number of
kernel launches, and the twelve kernels with the most device time. It also
prints the unprofiled ms per step (over 10 steps; 3 for the long windows).
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


def bench_batch(rng, b, groups):
    import numpy as np

    batch = []
    for _ in range(b):
        items = []
        for _ in range(groups):
            items += [rng.integers(0, 256, 32).astype(np.int32),
                      (0, rng.standard_normal((14, 14, 32)).astype(np.float32)),
                      rng.integers(0, 256, 8).astype(np.int32)]
        batch.append(items)
    return batch


# scripts/probe_573m.py:29-41, as chip_smoke.py's LONG_CFG
LONG_CFG = dict(
    num_text_tokens=50_000, dim_latent=32, modality_default_shape=(14, 14), pad_multiple=64,
    ce_chunk_size=256,
    transformer=dict(dim=1024, depth=12, dim_head=64, heads=16, attn_impl="flash"),
)


def long_sample(rng):
    """chip_smoke.py's long sample: 20 x ([600 text][14x14x32 latent]) then
    270 text, n 16384 after the shift."""
    import numpy as np

    items = []
    for _ in range(20):
        items += [rng.integers(0, 50_000, 600).astype(np.int32),
                  (0, rng.standard_normal((14, 14, 32)).astype(np.float32))]
    return items + [rng.integers(0, 50_000, 270).astype(np.int32)]


def profile(torch, name, step, tokens, warmup=2, timed=10):
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / timed * 1e3
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "window": name, "ms_per_step_unprofiled": ms_step,
        "packed_tokens_per_s_unprofiled": tokens / ms_step * 1e3,
        "wall_s": wall, "device_kernel_ms": device_ms,
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
    from transfusion_tpu_torch.training import Trainer

    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    trainer = Trainer(model, learning_rate=3e-4)
    rng = np.random.default_rng(0)
    for name, b, groups in (("train_step token-major, b32 n256", 32, 1),
                            ("train_step head-major, b8 n1024", 8, 4)):
        packed = model.pack(bench_batch(rng, b, groups), shift_friendly=True).to_torch("cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        box = [trainer.init_state()]

        def step(packed=packed, gen=gen, box=box):
            box[0], _ = trainer.train_step(box[0], packed, generator=gen)

        profile(torch, name, step, int(packed.total_tokens))
    del model, trainer
    long_windows(torch, Transfusion, Trainer)
    return 0


def long_windows(torch, Transfusion, Trainer):
    """The long-context step under remat 'full', 'dots' and none: a profiled
    window each, the peak memory of one microbatch's forward and backward
    above what stays resident (the state, the weights), and the peak of a
    whole step with one state resident."""
    import numpy as np

    rng = np.random.default_rng(0)
    packs = None
    for policy in ("full", "dots", None):
        tcfg = dict(LONG_CFG["transformer"], remat=policy is not None,
                    remat_policy=policy or "full")
        model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0,
                            **dict(LONG_CFG, transformer=tcfg))
        trainer = Trainer(model, learning_rate=3e-4, grad_accumulation=2)
        if packs is None:
            packs = [model.pack([long_sample(rng)], shift_friendly=True).to_torch("cuda")
                     for _ in range(2)]
        tokens = sum(int(p.total_tokens) for p in packs)
        gen = torch.Generator("cuda").manual_seed(0)
        box = [trainer.init_state()]

        def step(trainer=trainer, gen=gen, box=box):
            box[0], _ = trainer.train_step(box[0], packs, generator=gen)

        label = f"remat {policy}" if policy else "no remat"
        profile(torch, f"train_step 573M, 2 x n16384, grad_accumulation 2, {label}", step,
                tokens, warmup=1, timed=3)

        leaves = {k: p.detach().requires_grad_(True) for k, p in box[0].params.items()}
        draws = model.make_draws(packs[0], gen)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = model.loss(packed=packs[0], draws=draws, params=leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        torch.cuda.synchronize()
        microbatch = torch.cuda.max_memory_allocated() - resident
        del loss, grads, leaves
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        print(json.dumps({
            "window": f"memory, train_step 573M, 2 x n16384, grad_accumulation 2, {label}",
            "resident_gb": resident / 1e9,
            "microbatch_forward_backward_peak_above_resident_gb": microbatch / 1e9,
            "step_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        }), flush=True)
        del model, trainer, box, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
