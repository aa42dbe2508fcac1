"""Flowers latents interleaved with byte-encoded captions, and CFG sampling
(twin of `examples/train_latent_with_text.py`): dim 128, depth 8,
reconstruction loss 0.1, U-Net halves, EMA sampling with CFG. The latents
are synthetic stand-ins (see train_latent_only).

Run: python -m transfusion_tpu_torch.examples.train_latent_with_text --steps 200
"""

import numpy as np

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.dataloader import create_dataloader, cycle
from transfusion_tpu_torch.data.datasets import load_flowers_labels, load_flowers_latents
from transfusion_tpu_torch.examples._common import generator, parse_args, train_loop
from transfusion_tpu_torch.models.modality_io import SameConv2d, SameConvTranspose2d
from transfusion_tpu_torch.training import Trainer
from transfusion_tpu_torch.utils.helpers import print_modality_sample


def main():
    args = parse_args(default_steps=200, default_sample_every=100, batch_size=4)

    model = Transfusion(
        num_text_tokens=256,  # bytes
        dim_latent=4,
        modality_default_shape=(32, 32),
        pre_post_transformer_enc_dec=(SameConv2d(4, 128), SameConvTranspose2d(128, 4)),
        reconstruction_loss_weight=0.1,
        prob_uncond=0.1,
        transformer=dict(dim=128, depth=8, dim_head=32, heads=8),
        pad_multiple=64,
        device=args.device,
        seed=args.seed,
    )
    trainer = Trainer(model, learning_rate=3e-4, grad_clip_norm=0.5)
    state = trainer.init_state()

    latents = load_flowers_latents(n=512)
    labels = load_flowers_labels()
    dataset = [(np.frombuffer(labels[i % len(labels)].encode(), np.uint8).astype(np.int32),
                latents[i]) for i in range(len(latents))]
    iter_dl = cycle(create_dataloader(dataset, batch_size=args.batch_size, shuffle=True))

    def hook(step, state):
        if step % args.sample_every == 0:
            caption = np.frombuffer(labels[0].encode(), np.uint8).astype(np.int32)
            sample = model.create_ema(state.ema.params).sample(
                prompt=caption, generator=generator(model.device, step), max_length=16,
                modality_steps=16, cfg_scale=3.0)
            print_modality_sample(sample)

    train_loop(trainer, state, iter_dl, args.steps, generator(model.device, 1), hook=hook)


if __name__ == "__main__":
    main()
