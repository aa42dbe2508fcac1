"""Byte-level language modeling, enwik8 when present, else the repository's
own text (twin of `examples/train_text_only.py`): dim 384, depth 8, LASER
attention, sequences of 256, batch 4 x gradient accumulation 4 through
MultiSteps, periodic generation.

Run: python -m transfusion_tpu_torch.examples.train_text_only --steps 200
"""

import numpy as np
import torch

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.datasets import load_enwik8
from transfusion_tpu_torch.examples._common import generator, load_params, parse_args
from transfusion_tpu_torch.training import (
    MultiSteps,
    adam,
    apply_updates,
    chain,
    clip_by_global_norm,
    ema_update,
    init_ema,
)

SEQ_LEN = 256


def main():
    args = parse_args(default_steps=200, default_sample_every=100, batch_size=4)
    grad_accum = 4

    model = Transfusion(
        num_text_tokens=256,
        dim_latent=384,
        modality_default_shape=(),
        transformer=dict(dim=384, depth=8, dim_head=64, heads=8, attn_laser=True),
        device=args.device,
        seed=args.seed,
    )
    tx = chain(clip_by_global_norm(0.5), MultiSteps(adam(3e-4), every_k_schedule=grad_accum))
    params = {k: p.detach().float().clone() for k, p in model.core.named_parameters()}
    opt_state, ema = tx.init(params), init_ema(params)

    data = load_enwik8()
    split = int(len(data) * 0.9)
    train_data, valid_data = data[:split], data[split:]
    rng_np = np.random.default_rng(args.seed)

    def sample_batch(source):
        idx = rng_np.integers(0, len(source) - SEQ_LEN - 1, args.batch_size)
        batch = np.stack([source[i:i + SEQ_LEN + 1] for i in idx]).astype(np.int64)
        return torch.as_tensor(batch, device=model.device)

    for step in range(1, args.steps + 1):
        for _ in range(grad_accum):
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            loss = model._text_loss_impl(sample_batch(train_data), params=leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(leaves.items(), grads)}
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates({k: p.detach() for k, p in params.items()}, updates)
            ema = ema_update(ema, params)
        if step % 10 == 0 or step == 1:
            with torch.no_grad():
                vloss = model._text_loss_impl(sample_batch(valid_data), params=params)
            print(f"{step}: train {loss.item():.4f} valid {vloss.item():.4f}")

        if step % args.sample_every == 0:
            prime = sample_batch(valid_data)[:1, :64]
            load_params(model, params)
            out = model.generate_text_only(prime, seq_len=64 + 128,
                                           generator=generator(model.device, step))
            text = bytes(out[0].cpu().clamp(0, 255).tolist()).decode("utf-8", errors="replace")
            print("SAMPLE:", repr(text[:200]))


if __name__ == "__main__":
    main()
