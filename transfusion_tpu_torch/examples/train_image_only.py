"""Unconditional MNIST flow matching with velocity consistency and Muon
(twin of `examples/train_image_only.py`): the modality-only path, the
velocity-consistency term against the EMA, the reconstruction term, LASER
attention, MuonAdamAtan2 on the matrices.

Run: python -m transfusion_tpu_torch.examples.train_image_only --steps 300
"""

import pathlib

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.datasets import load_mnist
from transfusion_tpu_torch.examples._common import (
    MnistPatchDecoder,
    MnistPatchEncoder,
    generator,
    modality_only_loop,
    parse_args,
    save_image_grid,
)
from transfusion_tpu_torch.training import chain, clip_by_global_norm, muon_adam_atan2


def main():
    args = parse_args(default_steps=300, default_sample_every=150, batch_size=32)

    model = Transfusion(
        num_text_tokens=1,  # modality-only training; a 1-token placeholder
        dim_latent=4,
        modality_default_shape=(14, 14),
        modality_encoder=MnistPatchEncoder(),
        modality_decoder=MnistPatchDecoder(),
        reconstruction_loss_weight=0.1,
        velocity_consistency_loss_weight=0.1,
        transformer=dict(dim=64, depth=4, dim_head=32, heads=8, attn_laser=True),
        device=args.device,
        seed=args.seed,
    )
    tx = chain(clip_by_global_norm(0.5), muon_adam_atan2(muon_lr=3e-4, adam_lr=3e-4))
    images, _ = load_mnist()
    pathlib.Path("results").mkdir(exist_ok=True)

    def sample(step, ema_params):
        out = model.create_ema(ema_params).generate_modality_only(
            batch_size=16, modality_steps=16, generator=generator(model.device, step))
        save_image_grid(out.cpu().numpy(), f"results/image_only_{step}")

    modality_only_loop(model, tx, images, args, sample, velocity=True)


if __name__ == "__main__":
    main()
