"""Serving demo: batched text generation and multimodal sampling through
the KV-cache path (twin of `examples/serve_text.py`): the flash kernel's
prefill into a preallocated cache, per-token decode through the decode
kernel, an optional int8 KV cache (--kv-quantize), ragged batches, and
both continuous-batching engines.

Run: python -m transfusion_tpu_torch.examples.serve_text --history 2048 --tokens 64 --batch 4
     python -m transfusion_tpu_torch.examples.serve_text --kv-quantize --checkpoint runs/ckpt

--checkpoint reads the port's own `Trainer` checkpoints (`step_<n>.pt`
files written by `Trainer.save`), not the JAX package's orbax directories.
"""

import argparse
import time

import numpy as np
import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--history", type=int, default=512, help="prompt length to prefill")
    p.add_argument("--tokens", type=int, default=64, help="tokens to decode per request")
    p.add_argument("--batch", type=int, default=4,
                   help="concurrent requests (batched decode)")
    p.add_argument("--kv-quantize", action="store_true",
                   help="int8 KV cache (2x smaller, wins at long history)")
    p.add_argument("--attn", default="flash", choices=["flash", "dense"])
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--checkpoint", default=None,
                   help="directory of the port's Trainer checkpoints (step_<n>.pt, from "
                        "Trainer.save) to restore the weights from; not an orbax directory")
    p.add_argument("--multimodal", action="store_true",
                   help="also run one cached multimodal sample()")
    p.add_argument("--engine", action="store_true",
                   help="demo the continuous-batching ServingEngine: more requests than "
                        "slots, admission + early retirement")
    p.add_argument("--ragged", action="store_true",
                   help="demo ragged batching: requests with different history lengths "
                        "decode together")
    p.add_argument("--mm-engine", action="store_true",
                   help="demo the continuous-batching MULTIMODAL engine: full sample()-style "
                        "requests (text + image segments + CFG) over a slot pool")
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' runs the plain "
                   "PyTorch path on a machine without a GPU")
    args = p.parse_args()

    from transfusion_tpu_torch import Transfusion

    model = Transfusion(
        num_text_tokens=256,
        dim_latent=32,
        modality_default_shape=(14, 14),
        transformer=dict(dim=args.dim, depth=args.depth, dim_head=64,
                         heads=args.dim // 48 if args.dim % 48 == 0 else 8,
                         attn_impl=args.attn),
        pad_multiple=64,
        dtype=torch.bfloat16,
        device=args.device,
        seed=0,
    )
    if args.checkpoint:
        from transfusion_tpu_torch.training import Trainer

        trainer = Trainer(model, checkpoint_dir=args.checkpoint)
        state = trainer.restore()
        if state is not None:
            trainer.sync_model(state)
            print(f"restored step {state.step} from {args.checkpoint}")

    def gen(seed):
        return torch.Generator(model.device).manual_seed(seed)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (args.batch, args.history)).astype(np.int32)

    # warm up; then measure steady state
    toks = model.generate_text_only(prompt, seq_len=args.history + args.tokens,
                                    generator=gen(1), kv_quantize=args.kv_quantize)
    sync()
    t0 = time.perf_counter()
    toks = model.generate_text_only(prompt, seq_len=args.history + args.tokens,
                                    generator=gen(2), kv_quantize=args.kv_quantize)
    sync()
    dt = time.perf_counter() - t0

    total = args.batch * args.tokens
    cache = "int8" if args.kv_quantize else "bf16"
    print(f"decode: {args.batch} req x {args.tokens} tok @ history {args.history} ({cache} "
          f"cache): {dt:.2f} s = {total / dt:.0f} tok/s ({dt / args.tokens * 1e3:.2f} ms/step)")
    print("sampled tail:", toks[0, -8:].tolist())

    if args.ragged:
        # each request has its own history length; per-row cache offsets
        # let them decode in one batch
        lens = [max(1, args.history // (i + 1)) for i in range(args.batch)]
        ragged_prompts = [rng.integers(0, 256, n).astype(np.int32) for n in lens]
        t0 = time.perf_counter()
        model.generate_text_batch(ragged_prompts, max_new_tokens=args.tokens,
                                  generator=gen(4), kv_quantize=args.kv_quantize)
        sync()
        dt = time.perf_counter() - t0
        print(f"ragged batch (histories {lens}): {args.tokens} tok/request in {dt:.2f} s")

    if args.engine:
        # continuous batching: a slot pool with admission and retirement;
        # --batch slots, 2x --batch requests
        from transfusion_tpu_torch.models.engine import ServingEngine

        n_req = args.batch * 2
        lens = [max(1, args.history // (i % args.batch + 1)) for i in range(n_req)]
        budgets = [args.tokens // (2 if i % 2 else 1) for i in range(n_req)]
        eng = ServingEngine(model, max_batch=args.batch, max_seq_len=args.history + args.tokens,
                            decode_chunk=16, kv_quantize=args.kv_quantize or None)
        for n, b in zip(lens, budgets):
            eng.submit(rng.integers(0, 256, n).astype(np.int32), b)
        t0 = time.perf_counter()
        done = eng.run()
        sync()
        dt = time.perf_counter() - t0
        got = sum(len(r.tokens) for r in done)
        print(f"engine ({n_req} req over {args.batch} slots, histories {lens}, budgets "
              f"{budgets}): {got} tok in {dt:.2f} s ({eng.stats['decode_chunks']} chunks)")

    if args.mm_engine:
        # continuous batching of whole sample() requests: text, [som]-started
        # image segments by the flow ODE, CFG
        from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine

        n_req = args.batch * 2
        som = model.som_ids[0]
        mm_prompts, mm_budgets = [], []
        for i in range(n_req):
            hist = rng.integers(0, 256, 24 + 8 * (i % 3)).astype(np.int32)
            if i % 4 == 0:  # a forced image segment, then a text tail
                mm_prompts.append([np.concatenate([hist, np.asarray([som], np.int32)])])
                mm_budgets.append(220)  # 14x14 = 196 latent rows + the text tail
            else:
                mm_prompts.append([hist])
                mm_budgets.append(16)
        eng = MultimodalServingEngine.for_workload(
            model, mm_prompts, max(mm_budgets), max_requests=args.batch, modality_steps=8,
            cfg_scale=3.0, return_unprocessed_modalities=True)
        for mp, mb in zip(mm_prompts, mm_budgets):
            eng.submit(mp, max_length=mb)
        t0 = time.perf_counter()
        eng.run()
        sync()
        dt = time.perf_counter() - t0
        print(f"mm-engine ({n_req} sample()-requests over {args.batch} slots): "
              f"{eng.stats['text_tokens']} text + {eng.stats['modality_tokens']} latent tokens "
              f"in {dt:.2f} s ({eng.stats['text_chunks']} text chunks, "
              f"{eng.stats['ode_dispatches']} ODE dispatches)")

    if args.multimodal:
        t0 = time.perf_counter()
        out = model.sample(prompt=[np.asarray([model.som_ids[0]], np.int32)], generator=gen(3),
                           max_length=8, modality_steps=16, cache_kv=True,
                           kv_quantize=args.kv_quantize, return_unprocessed_modalities=True)
        sync()
        dt = time.perf_counter() - t0
        kinds = ["mod" if isinstance(o, tuple) else "text" for o in out]
        print(f"multimodal sample() ({cache} cache): {dt:.2f} s, {kinds}")


if __name__ == "__main__":
    main()
