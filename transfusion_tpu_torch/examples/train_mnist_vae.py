"""Two stages: a small conv autoencoder trained with the noised-latent
trick, then Transfusion on its 7x7x16 latents (twin of
`examples/train_mnist_vae.py`). The encoder and decoder stay frozen and
outside the trained parameters.

Run: python -m transfusion_tpu_torch.examples.train_mnist_vae --steps 300
"""

import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.dataloader import create_dataloader, cycle
from transfusion_tpu_torch.data.datasets import load_mnist
from transfusion_tpu_torch.examples._common import (
    generator,
    parse_args,
    save_image_grid,
    train_loop,
)
from transfusion_tpu_torch.models.modality_io import SameConv2d, SameConvTranspose2d
from transfusion_tpu_torch.training import Trainer

DIM_LATENT = 16


class Encoder(nn.Module):
    """[.., 28, 28] pixels -> [.., 7, 7, DIM_LATENT]: two flax-`SAME`
    convs, 4x4 stride 2, with flax's tanh gelu between them."""

    def __init__(self):
        super().__init__()
        self.conv0 = SameConv2d(1, 32, kernel_size=4, stride=2)
        self.conv1 = SameConv2d(32, DIM_LATENT, kernel_size=4, stride=2)

    def forward(self, x):
        lead = x.shape[:-2]
        h = x.reshape(-1, *x.shape[-2:], 1) * 2 - 1
        z = self.conv1(F.gelu(self.conv0(h), approximate="tanh"))
        return z.reshape(*lead, *z.shape[1:])


class Decoder(nn.Module):
    """[.., 7, 7, DIM_LATENT] -> [.., 28, 28] pixels in [0, 1]: two flax
    `ConvTranspose`s, 4x4 stride 2."""

    def __init__(self):
        super().__init__()
        self.deconv0 = SameConvTranspose2d(DIM_LATENT, 32, kernel_size=4, stride=2)
        self.deconv1 = SameConvTranspose2d(32, 1, kernel_size=4, stride=2)

    def forward(self, z):
        lead = z.shape[:-3]
        x = self.deconv1(F.gelu(self.deconv0(z.reshape(-1, *z.shape[-3:])), approximate="tanh"))
        x = ((x[..., 0] + 1) * 0.5).clamp(0.0, 1.0)
        return x.reshape(*lead, *x.shape[1:])


def train_autoencoder(images, device, steps=300, batch=64, seed=0):
    enc, dec = Encoder().to(device), Decoder().to(device)
    opt = torch.optim.Adam([*enc.parameters(), *dec.parameters()], lr=1e-3)
    rng_np = np.random.default_rng(seed)
    gen = generator(device, seed + 1)
    for i in range(steps):
        x = torch.as_tensor(images[rng_np.integers(0, len(images), batch)], device=device)
        z = enc(x)
        # noised-latent robustness trick: noise of a random scale in [0, 0.3)
        t = torch.rand((z.shape[0], 1, 1, 1), generator=gen, device=device) * 0.3
        z_noised = z + torch.randn(z.shape, generator=gen, device=device) * t
        loss = ((dec(z_noised) - x) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 50 == 0:
            print(f"ae {i}: {loss.item():.4f}")
    return enc, dec


def main():
    args = parse_args(default_steps=300, default_sample_every=150, batch_size=16, ae_steps=200)
    images, labels = load_mnist()
    enc, dec = train_autoencoder(images, args.device, steps=args.ae_steps, seed=args.seed)

    model = Transfusion(
        num_text_tokens=10,
        dim_latent=DIM_LATENT,
        modality_default_shape=(7, 7),
        modality_encoder=enc,
        modality_decoder=dec,
        transformer=dict(dim=64, depth=4, dim_head=32, heads=8),
        pad_multiple=64,
        device=args.device,
        seed=args.seed,
    )
    trainer = Trainer(model, learning_rate=8e-4, grad_clip_norm=0.5)
    state = trainer.init_state()

    dataset = [(np.array([label], np.int32), img) for img, label in zip(images, labels)]
    iter_dl = cycle(create_dataloader(dataset, batch_size=args.batch_size, shuffle=True))

    pathlib.Path("results").mkdir(exist_ok=True)

    def hook(step, state):
        if step % args.sample_every == 0:
            sample = model.create_ema(state.ema.params).sample(
                prompt=np.array([step % 10], np.int32), generator=generator(model.device, step),
                max_length=8, modality_steps=16, cfg_scale=3.0)
            for item in sample:
                if isinstance(item, tuple):
                    save_image_grid(item[1][None], f"results/mnist_vae_{step}")

    train_loop(trainer, state, iter_dl, args.steps, generator(model.device, 1), hook=hook)


if __name__ == "__main__":
    main()
