"""Distributed training: data x fsdp x tensor (x context, or x pipe) over a
device mesh (twin of `examples/train_distributed.py`). One process per
rank, started by torchrun; every rank builds the same model, batches and
draws.

On the CPU (gloo), 4 processes, the sequence sharded over 2 with ring
attention:

  torchrun --standalone --nproc_per_node=4 -m \\
      transfusion_tpu_torch.examples.train_distributed --device cpu --context 2

On GPUs (NCCL), one process per card:

  torchrun --standalone --nproc_per_node=<cards> -m \\
      transfusion_tpu_torch.examples.train_distributed --steps 10

The ranks left after --context are factored into data x fsdp x tensor as
the JAX script does (`factor_devices`).

Pipeline parallelism: the whole joint loss with the transformer split into
--pipeline stages over a 'pipe' axis and the other ranks on 'data' (GPipe,
`Trainer(pipeline_microbatches=)`, `parallel/pipeline.py`):

  torchrun --standalone --nproc_per_node=4 -m \\
      transfusion_tpu_torch.examples.train_distributed --device cpu --pipeline 4
"""

import pathlib

import numpy as np
import torch.distributed as dist

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.dataloader import create_dataloader, cycle
from transfusion_tpu_torch.examples._common import generator, parse_args, train_loop
from transfusion_tpu_torch.parallel import initialize_distributed, make_mesh
from transfusion_tpu_torch.training import Trainer


def factor_devices(n):
    """n ranks as [data, fsdp, tensor]: prime factors dealt round-robin."""
    dims = [1, 1, 1]
    i, k = 0, 2
    while n > 1:
        while n % k == 0:
            dims[i % 3] *= k
            n //= k
            i += 1
        k += 1
    return dims


def dataset(seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, 16).astype(np.int32),
             rng.standard_normal((8, 8, 32)).astype(np.float32)) for _ in range(256)]


def train_pipeline(args, rank: int, n_dev: int):
    """GPipe training of the whole Transfusion model through the Trainer
    (the JAX `train_pipeline`): the transformer as stages over 'pipe', the
    ranks left over on 'data'."""
    pipe = args.pipeline
    if n_dev % pipe:
        raise ValueError(f"{n_dev} devices not divisible by pipe={pipe}")
    data = n_dev // pipe
    mesh = make_mesh(data=data, pipe=pipe, device=args.device)
    # the largest M <= 2 * pipe with the batch divisible by M and each
    # microbatch's rows by the data axis (bubble fraction (pipe-1)/(M+pipe-1))
    bs = max(args.batch_size, 2 * pipe * data)
    microbatches = pipe
    for m in range(min(2 * pipe, bs), pipe - 1, -1):
        if bs % m == 0 and (bs // m) % data == 0:
            microbatches = m
            break
    if rank == 0:
        print(f"devices={n_dev} mesh: data={data} pipe={pipe} microbatches={microbatches} "
              f"batch={bs}")
    model = Transfusion(num_text_tokens=256, dim_latent=32, modality_default_shape=(8, 8),
                        transformer=dict(dim=256, depth=4 * max(pipe // 4, 1), dim_head=64,
                                         heads=8, unet_skips=False, num_residual_streams=1),
                        pad_multiple=64, device=args.device, seed=args.seed)
    if rank == 0:
        pathlib.Path("results").mkdir(exist_ok=True)
    trainer = Trainer(model, learning_rate=3e-4, mesh=mesh, pipeline_microbatches=microbatches,
                      metrics_path="results/distributed_metrics.jsonl" if rank == 0 else None)
    iter_dl = cycle(create_dataloader(dataset(args.seed), batch_size=bs, shuffle=True))
    train_loop(trainer, trainer.init_state(), iter_dl, args.steps, generator(model.device, 1),
               log_every=10 if rank == 0 else args.steps + 1)


def main():
    args = parse_args(default_steps=20, default_sample_every=10**9, batch_size=8, context=1,
                      pipeline=1)
    rank, n_dev = initialize_distributed(device=args.device)
    try:
        if args.pipeline > 1:
            return train_pipeline(args, rank, n_dev)
        context = max(1, args.context)
        if n_dev % context:
            raise ValueError(f"{n_dev} ranks do not divide by --context {context}")
        data, fsdp, tensor = factor_devices(n_dev // context)
        mesh = make_mesh(data=data, fsdp=fsdp, tensor=tensor, context=context,
                         device=args.device)
        if rank == 0:
            print(f"devices={n_dev} mesh: data={data} fsdp={fsdp} tensor={tensor} "
                  f"context={context}")

        tcfg = dict(dim=256, depth=4, dim_head=64, heads=8)
        if context > 1:
            tcfg.update(attn_impl="ring", mesh=mesh)
        model = Transfusion(num_text_tokens=256, dim_latent=32, modality_default_shape=(8, 8),
                            transformer=tcfg, pad_multiple=64, device=args.device,
                            seed=args.seed)
        if rank == 0:
            pathlib.Path("results").mkdir(exist_ok=True)
        trainer = Trainer(model, learning_rate=3e-4, mesh=mesh, metrics_path=(
            "results/distributed_metrics.jsonl" if rank == 0 else None))
        state = trainer.init_state()

        # the batch size must be divisible by the data axis
        bs = max(args.batch_size, data) // data * data
        iter_dl = cycle(create_dataloader(dataset(args.seed), batch_size=bs, shuffle=True))
        train_loop(trainer, state, iter_dl, args.steps, generator(model.device, 1),
                   log_every=10 if rank == 0 else args.steps + 1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
