"""Label -> image on raw 2x2-patchified MNIST pixels, dim_latent 4 (twin of
`examples/train_mnist.py`): patch encoder / decoder, prob_uncond 0.1, EMA
sampling with cfg_scale 3.0.

Run: python -m transfusion_tpu_torch.examples.train_mnist --steps 500
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
from transfusion_tpu_torch.training import Trainer
from transfusion_tpu_torch.utils.helpers import print_modality_sample

IMAGE_AFTER_TEXT = True


def main():
    args = parse_args(default_steps=500, default_sample_every=250, batch_size=16)

    model = Transfusion(
        num_text_tokens=10,
        dim_latent=4,
        modality_default_shape=(14, 14),
        modality_encoder=MnistPatchEncoder(),
        modality_decoder=MnistPatchDecoder(),
        prob_uncond=0.1,
        transformer=dict(dim=64, depth=4, dim_head=32, heads=8),
        pad_multiple=256,
        device=args.device,
        seed=args.seed,
    )
    trainer = Trainer(model, learning_rate=8e-4, grad_clip_norm=0.5)
    state = trainer.init_state()

    images, labels = load_mnist()
    dataset = [((np.array([label], np.int32), img) if IMAGE_AFTER_TEXT
                else (img, np.array([label], np.int32)))
               for img, label in zip(images, labels)]
    iter_dl = cycle(create_dataloader(dataset, batch_size=args.batch_size, shuffle=True))

    def hook(step, state):
        if step % args.sample_every == 0:
            sample = model.create_ema(state.ema.params).sample(
                prompt=np.array([step % 10], np.int32), generator=generator(model.device, step),
                max_length=8, modality_steps=16, cfg_scale=3.0)
            print_modality_sample(sample)
            for item in sample:
                if isinstance(item, tuple):
                    save_image_grid(item[1][None], f"results/mnist_{step}")

    pathlib.Path("results").mkdir(exist_ok=True)
    train_loop(trainer, state, iter_dl, args.steps, generator(model.device, 1), hook=hook)


if __name__ == "__main__":
    main()
