"""Flow matching on flowers VAE latents, the modality-only path (twin of
`examples/train_latent_only.py`): dim 256, depth 8, 32x32x4 latents
(synthetic stand-ins of the same shape and scale, `data/datasets.py`).

Run: python -m transfusion_tpu_torch.examples.train_latent_only --steps 200
"""

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.datasets import load_flowers_latents
from transfusion_tpu_torch.examples._common import generator, modality_only_loop, parse_args
from transfusion_tpu_torch.training import adam, chain, clip_by_global_norm


def main():
    args = parse_args(default_steps=200, default_sample_every=100, batch_size=8)

    model = Transfusion(
        num_text_tokens=1,
        dim_latent=4,
        channel_first_latent=False,  # latents stored channel-last here
        modality_default_shape=(32, 32),
        transformer=dict(dim=256, depth=8, dim_head=32, heads=8),
        device=args.device,
        seed=args.seed,
    )
    tx = chain(clip_by_global_norm(0.5), adam(3e-4))
    latents = load_flowers_latents()

    def sample(step, ema_params):
        out = model.create_ema(ema_params).generate_modality_only(
            batch_size=4, modality_steps=16, generator=generator(model.device, step))
        print("sampled latents:", tuple(out.shape), "std", float(out.std()))

    modality_only_loop(model, tx, latents, args, sample)


if __name__ == "__main__":
    main()
