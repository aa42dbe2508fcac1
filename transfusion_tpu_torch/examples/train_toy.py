"""Smallest smoke config: a constant text token + a 2x16 latent (twin of
`examples/train_toy.py`).

Run: python -m transfusion_tpu_torch.examples.train_toy --steps 200
"""

import numpy as np

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.dataloader import create_dataloader, cycle
from transfusion_tpu_torch.examples._common import generator, parse_args, train_loop
from transfusion_tpu_torch.training import Trainer
from transfusion_tpu_torch.utils.helpers import print_modality_sample


def main():
    args = parse_args(default_steps=200)
    model = Transfusion(
        num_text_tokens=8,
        dim_latent=16,
        modality_default_shape=(2,),
        transformer=dict(dim=64, depth=1, dim_head=8, heads=2),
        pad_multiple=16,
        device=args.device,
        seed=args.seed,
    )
    trainer = Trainer(model, learning_rate=3e-4, grad_clip_norm=0.5)
    state = trainer.init_state()

    data_rng = np.random.default_rng(args.seed)
    dataset = [(np.ones(1, np.int32), data_rng.standard_normal((2, 16)).astype(np.float32))
               for _ in range(100)]
    iter_dl = cycle(create_dataloader(dataset, batch_size=args.batch_size))

    def hook(step, state):
        if step % args.sample_every == 0:
            sample = model.create_ema(state.ema.params).sample(
                generator=generator(model.device, step), max_length=16, modality_steps=8)
            print_modality_sample(sample)

    train_loop(trainer, state, iter_dl, args.steps, generator(model.device, 1), hook=hook)


if __name__ == "__main__":
    main()
