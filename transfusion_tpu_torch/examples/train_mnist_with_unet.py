"""MNIST with learnable U-Net halves around the transformer (twin of
`examples/train_mnist_with_unet.py`): `pre_post_transformer_enc_dec`, a
flax-`SAME` 3x3 stride-2 conv pair taking the 14x14 patches to 7x7 rows
inside the model.

Run: python -m transfusion_tpu_torch.examples.train_mnist_with_unet --steps 300
"""

import pathlib

import numpy as np

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.dataloader import create_dataloader, cycle
from transfusion_tpu_torch.data.datasets import load_mnist
from transfusion_tpu_torch.examples._common import (
    MnistPatchDecoder,
    MnistPatchEncoder,
    generator,
    parse_args,
    save_image_grid,
    train_loop,
)
from transfusion_tpu_torch.models.modality_io import SameConv2d, SameConvTranspose2d
from transfusion_tpu_torch.training import Trainer

DIM = 64


def main():
    args = parse_args(default_steps=300, default_sample_every=150, batch_size=16)

    model = Transfusion(
        num_text_tokens=10,
        dim_latent=4,
        modality_default_shape=(14, 14),
        modality_encoder=MnistPatchEncoder(),
        modality_decoder=MnistPatchDecoder(),
        # Down: [b, 14, 14, 4] -> [b, 7, 7, DIM]; Up: back
        pre_post_transformer_enc_dec=(SameConv2d(4, DIM), SameConvTranspose2d(DIM, 4)),
        transformer=dict(dim=DIM, depth=4, dim_head=32, heads=8),
        pad_multiple=64,
        device=args.device,
        seed=args.seed,
    )
    trainer = Trainer(model, learning_rate=8e-4, grad_clip_norm=0.5)
    state = trainer.init_state()

    images, labels = load_mnist()
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
                    save_image_grid(item[1][None], f"results/mnist_unet_{step}")

    train_loop(trainer, state, iter_dl, args.steps, generator(model.device, 1), hook=hook)


if __name__ == "__main__":
    main()
