"""Shared pieces of the example twins: the JAX scripts' flags (plus
`--device`), the training loop, the image dump, the parameter-free patch
codec of the MNIST scripts (single-channel images, no channel axis) and the
modality-only training loop of the image- and latent-only scripts."""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from transfusion_tpu_torch.models.modality_io import PatchDecoder, PatchEncoder
from transfusion_tpu_torch.training import apply_updates, ema_update, init_ema


def parse_args(default_steps=200, default_sample_every=100, **extra):
    """The JAX scripts' flags and `--device`. Seeds torch's global
    generator with --seed: modules built outside the model (U-Net halves,
    the autoencoder) draw their initial weights from it."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=default_steps)
    p.add_argument("--sample-every", type=int, default=default_sample_every)
    p.add_argument("--batch-size", type=int, default=extra.pop("batch_size", 4))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device; 'cpu' runs the plain "
                   "PyTorch path on a machine without a GPU")
    for k, v in extra.items():
        p.add_argument(f"--{k.replace('_', '-')}", type=type(v), default=v)
    args = p.parse_args()
    torch.manual_seed(args.seed)
    return args


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def train_loop(trainer, state, iter_dl, steps, gen, log_every=10, hook=None):
    """`steps` Trainer steps on the loader's batches, draws from `gen`;
    prints the loss at step 1 and every `log_every` steps."""
    for step in range(1, steps + 1):
        state, metrics = trainer.train_step(state, next(iter_dl), generator=gen)
        if step % log_every == 0 or step == 1:
            print(f"{step}: {float(metrics['loss']):.4f}")
        if hook is not None:
            hook(step, state)
    return state


def load_params(model, params: dict):
    """Copy a parameter dict (e.g. float32 masters) into the model's
    modules, in their dtypes, for sampling."""
    with torch.no_grad():
        for k, p in model.core.named_parameters():
            p.copy_(params[k])


def modality_only_loop(model, tx, data, args, sample, velocity=False):
    """The image- and latent-only scripts' loop: `forward_modality` on
    `args.batch_size` random rows of `data` a step (with the
    velocity-consistency term against the EMA when `velocity`), `tx`'s
    update, the EMA (the JAX `ema_update` defaults) every step, and
    `sample(step, ema_params)` every `args.sample_every` steps."""
    params = {k: p.detach().float().clone() for k, p in model.core.named_parameters()}
    opt, ema = tx.init(params), init_ema(params)
    rng_np = np.random.default_rng(args.seed)
    gen = generator(model.device, 1)
    for step in range(1, args.steps + 1):
        idx = rng_np.integers(0, len(data), args.batch_size)
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        loss = model.forward_modality(data[idx], generator=gen, params=leaves,
                                      velocity_consistency_ema_params=ema.params if velocity
                                      else None)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        updates, opt = tx.update(grads, opt, params)
        params = apply_updates({k: p.detach() for k, p in params.items()}, updates)
        ema = ema_update(ema, params)
        if step % 10 == 0 or step == 1:
            print(f"{step}: {loss.item():.4f}")
        if step % args.sample_every == 0:
            sample(step, ema.params)
    return params, ema


def save_image_grid(images, path, pad=1):
    """images [n, h, w] or [n, h, w, 1] in [0, 1] -> `path`.npy, and an
    ASCII preview of the first."""
    images = np.asarray(images)
    if images.ndim == 4 and images.shape[-1] == 1:
        images = images[..., 0]
    np.save(str(path) + ".npy", images)
    img = images[0]
    chars = " .:-=+*#%@"
    h, w = img.shape
    rows = ["".join(chars[int(np.clip(img[y, x], 0, 1) * (len(chars) - 1))] for x in range(w))
            for y in range(0, h, 2)]
    print("\n".join(rows))


class MnistPatchEncoder(nn.Module):
    """The MNIST scripts' `PatchEncoder`: [.., 28, 28] pixels -> [.., 14,
    14, 4] patches in [-1, 1] (`PatchEncoder` on a channel axis of 1)."""

    def __init__(self):
        super().__init__()
        self.patch = PatchEncoder(2)

    def forward(self, x):
        lead = x.shape[:-2]
        y = self.patch(x.reshape(-1, *x.shape[-2:], 1))
        return y.reshape(*lead, *y.shape[1:])


class MnistPatchDecoder(nn.Module):
    """The inverse: [.., 14, 14, 4] -> [.., 28, 28] pixels in [0, 1]."""

    def __init__(self):
        super().__init__()
        self.patch = PatchDecoder(2)

    def forward(self, x):
        lead = x.shape[:-3]
        y = self.patch(x.reshape(-1, *x.shape[-3:]))[..., 0]
        return y.reshape(*lead, *y.shape[1:])
