"""Trainer: the joint training step with gradient clipping, an optimizer
and the EMA, metrics, a profiler window and checkpoints (counterpart of
`transfusion_tpu/training/trainer.py`).

The optimizer is `chain(clip_by_global_norm(grad_clip_norm), optimizer)`
(`training/optim.py`; `optimizer` defaults to `adam(learning_rate)`). With
the default optimizer and a constant learning rate the step takes the fused
clip + Adam + EMA pass (`training/fused_update.py`; `fused_update=`
overrides; `donate_state=True` lets it write the new state over the old),
else `update` -> `apply_updates` -> `ema_update`; grad_norm is the global
norm of the raw gradients either way.

The state holds float32 master weights, the optimizer's state and the EMA
copy, keyed by the core's parameter names. Each step casts the masters to
the model's compute dtype inside the autograd graph (`Transfusion.loss`
with `params=`), so the gradients arrive in float32, as they do for flax
modules with `dtype=bf16` over float32 params. The model's own module
weights are left as they were; `sync_model` copies a state into them (for
sampling with the trained weights).

With `grad_accumulation=M` a step splits its batch into M microbatches,
runs their forward and backward passes one after the other with the
batch's global loss denominators, sums their float32 gradients and makes
one update: the same update as the whole batch at once
(`_train_step_accum`, as the JAX `Trainer`).

With `velocity_consistency=True` every step adds the velocity-consistency
term, whose target is a no-grad forward of the state's EMA masters at
t + delta (the JAX `Trainer`'s `state.ema.params`).

Ragged batches are encoded (`Transfusion.encode_modalities`) before they
are packed, each microbatch on its own under grad accumulation.

`metrics_path` logs every step's metrics and packed tokens as JSONL
(`MetricsLogger`); `profile_logdir` writes a `torch.profiler` trace of
steps [profile_start_step, profile_start_step + profile_num_steps)
(`ProfilerHook`). Under any profiler a step shows as the span
`transfusion.train.step`, and inside it `.batch` (encoding, packing and
the copy to the device), `.draws` (the loss's draws when the caller passes
none, and the loss denominators the trainer computes), `.forward` and
`.backward` (each microbatch), `.reduce` (the mesh's reduction and the
accumulation's sum), `.update` and `.log` (`metrics_path`'s row, which
synchronises): `training.metrics.span`.

Randomness: `train_step` takes the loss's draws (`LossDraws`, or a list of
M of them) or makes them from a `torch.Generator`.

With `mesh=` (a `parallel.make_mesh` mesh; every rank of the group
constructs the same Trainer and calls it with the same batch and draws)
the state holds this rank's shards (`parallel.mesh.shard_params`: 'fsdp'
and 'tensor' splits of the masters, and of the optimizer state and EMA
alike). A step gathers the shards over 'fsdp' into the tensor-local
weights, takes its 'data' rows of the batch and draws
(`parallel.mesh.batch_sharding`) with the whole batch's loss denominators,
runs the loss (tensor-parallel on a 'tensor' axis; a model built with
attn_impl 'ring' / 'cp_allgather' and the same mesh shards attention over
'context'), sums the gradients of replicated parameters that compute on
tensor-local slices over 'tensor', sums everything over 'data' and
reduce-scatters over 'fsdp' (a mean: the fsdp ranks of a data row compute
the same loss, as JAX's `batch_sharding` replicates the batch over it);
the gradient of a shard that several fsdp or tensor ranks hold is their
mean, so its replicas stay equal where the ranks' backward passes differ
in their last bits (the card's attention backward adds dq with atomics).
The loss and its parts are summed over 'data', so every rank reports the
whole batch's. On a mesh that shards parameters ('fsdp' or 'tensor' > 1)
the update runs inside `optim.sharded`: `training/optim.py`'s
transformations are exact on the shards (global norms, the clip's and
grad_norm's included, sum every shard over 'fsdp' and 'tensor'; Muon
orthogonalizes whole matrices), so any chain of them works as
`optimizer=`; a transformation the caller writes sees this rank's shards.
Checkpoints gather the whole state, every optimizer state included, to
rank 0 in the usual format; `restore` reads it on every rank and shards it
again.

With `pipeline_microbatches=M` (a mesh with 'pipe' > 1) the loss runs
pipeline-parallel over the 'pipe' axis (`Transfusion._loss_impl(pipeline=)`):
`pipeline_schedule='gpipe'` (the GPipe trunk, `parallel/pipeline.py`;
data, fsdp and tensor axes alongside) or '1f1b' (the in-schedule loss,
`models/pipeline_loss.py`; 'pipe' and 'data' only). Every rank then takes
the whole batch and whole weights (the shards gathered over 'fsdp' and
'tensor'); the engines split the rows over 'data' and hand back the whole
loss and gradients on every rank, of which each keeps its shards, and the
update runs on those shards as above. A pipelined rank thus holds the
whole model, its float32 gradients and its optimizer state (JAX's
pipe-replicated layout): only the activations are split by stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from transfusion_tpu_torch.data.packing import PackedBatch
from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.mesh import (
    AXES,
    axis_of,
    axis_size,
    batch_sharding,
    gather_fsdp,
    set_tensor_axis,
    shard_params,
    shard_tensor,
    tensor_partial,
    unshard_tensor,
)
from transfusion_tpu_torch.training import optim
from transfusion_tpu_torch.training.ema import EmaState, ema_update, init_ema
from transfusion_tpu_torch.training.fused_update import fused_clip_adam_ema
from transfusion_tpu_torch.training.metrics import MetricsLogger, ProfilerHook, span


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict  # float32 master weights
    opt_state: Any  # the optimizer chain's state (`training/optim.py`)
    ema: EmaState
    step: int


def _structure(packed: PackedBatch) -> tuple:
    """What must match for packed batches to stack: the buffers' shapes and
    each latent group's type, sequence shape and shapes."""
    return (tuple(packed.text.shape), tuple(packed.spans.shape), tuple(
        (g.modality_type, tuple(g.seq_shape), tuple(g.latents.shape), tuple(g.batch_idx.shape))
        for g in packed.groups))


def _map_param_dicts(tree, names: frozenset, fn):
    """tree with fn(name, tensor) applied to every entry of each non-empty
    dict whose keys are parameter names and whose values are tensors: the
    params, the EMA copy, Adam's moments, and the moments of a
    `multi_transform` label, which hold a subset of the names. Matched by
    the keys alone, since the values are shards or whole tensors."""
    if isinstance(tree, dict):
        if tree and tree.keys() <= names and all(
                isinstance(v, torch.Tensor) for v in tree.values()):
            return {k: fn(k, v) for k, v in tree.items()}
        return {k: _map_param_dicts(v, names, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_param_dicts(v, names, fn) for v in tree)
    return tree


class Trainer:
    def __init__(self, model, optimizer: Optional[optim.GradientTransformation] = None,
                 learning_rate=3e-4, grad_clip_norm: Optional[float] = 0.5,
                 ema_beta: float = 0.99, ema_update_every: int = 10,
                 ema_update_after_step: int = 100, mesh=None,
                 velocity_consistency: bool = False,
                 velocity_consistency_delta_time: float = 1e-3,
                 checkpoint_dir: Optional[str] = None, metrics_path: Optional[str] = None,
                 profile_logdir: Optional[str] = None, profile_start_step: int = 10,
                 profile_num_steps: int = 3,
                 pipeline_microbatches: Optional[int] = None,
                 pipeline_schedule: str = "gpipe",
                 grad_accumulation: Optional[int] = None,
                 fused_update: Optional[bool] = None, donate_state: bool = False):
        """`donate_state`: the fused update writes the new state over the
        state it is given, as a jitted JAX step donates its buffers: a
        model whose float32 masters, Adam moments and EMA fill most of the
        card needs no second copy of them. The state passed to
        `train_step` is then the returned one."""
        self.model = model
        self.mesh = mesh
        self.pipeline_microbatches = pipeline_microbatches
        self.pipeline_schedule = pipeline_schedule
        if pipeline_microbatches is not None:
            self._validate_pipeline_config()
        if grad_accumulation is not None and grad_accumulation < 2:
            raise ValueError("grad_accumulation must be >= 2 (None disables it)")
        if grad_accumulation is not None and pipeline_microbatches is not None:
            raise ValueError("grad_accumulation and pipeline_microbatches both split the "
                             "batch — pick one")
        if fused_update is None:
            fused_update = optimizer is None and isinstance(learning_rate, (int, float))
        if fused_update and optimizer is not None:
            raise ValueError("fused_update runs clip + Adam only; it takes no optimizer")
        if donate_state and not fused_update:
            raise ValueError("donate_state takes the fused update (clip + Adam, no optimizer=)")
        self.donate_state = donate_state
        self._axes = self._specs = self._layout = None
        if mesh is not None:
            self._setup_mesh(mesh)
        self.velocity_consistency = velocity_consistency
        self.velocity_delta = velocity_consistency_delta_time
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        tx = optimizer or optim.adam(learning_rate)
        if grad_clip_norm is not None:
            tx = optim.chain(optim.clip_by_global_norm(grad_clip_norm), tx)
        self.tx = tx
        self.fused_update = fused_update
        self.ema_cfg = dict(beta=ema_beta, update_every=ema_update_every,
                            update_after_step=ema_update_after_step)
        self.checkpoint_dir = checkpoint_dir
        self.grad_accumulation = grad_accumulation
        self.metrics = MetricsLogger(metrics_path) if metrics_path else None
        self.profiler = (ProfilerHook(profile_logdir, profile_start_step, profile_num_steps)
                         if profile_logdir else None)

    def _validate_pipeline_config(self):
        """The JAX `_validate_pipeline_config` (`trainer.py:130-171`): its
        refusals, with its messages."""
        mesh = self.mesh
        if mesh is None or "pipe" not in getattr(mesh, "mesh_dim_names", ()):
            raise ValueError("pipeline_microbatches needs a mesh with a 'pipe' axis — "
                             "make_mesh(pipe=N)")
        sizes = {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}
        pipe = sizes["pipe"]
        if pipe <= 1:
            raise ValueError("pipeline_microbatches set but mesh pipe axis is 1")
        cfg = self.model.transformer_cfg
        if cfg.get("unet_skips", True) is not False:
            raise ValueError("pipeline parallelism requires transformer unet_skips=False "
                             "(cross-stage U-Net skips cannot be pipelined)")
        if cfg.get("num_residual_streams", 1) != 1:
            raise ValueError("pipeline parallelism requires num_residual_streams=1")
        if cfg.get("dropout", 0.0) != 0.0:
            raise ValueError("pipeline parallelism requires dropout=0")
        depth = cfg["depth"]
        if depth % pipe:
            raise ValueError(f"transformer depth {depth} must divide over pipe={pipe} stages")
        if self.pipeline_microbatches < pipe:
            raise ValueError(f"pick microbatches >= pipe ({pipe}); >= 2*pipe recommended "
                             "(bubble fraction (pipe-1)/(microbatches+pipe-1))")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule {self.pipeline_schedule!r}")
        if self.pipeline_schedule == "1f1b":
            bad = [f"{a}={n}" for a, n in sizes.items() if a not in ("pipe", "data") and n > 1]
            if bad:
                raise ValueError(
                    "the 1F1B schedule supports 'pipe' (+ optional 'data') mesh axes only "
                    f"(got {', '.join(bad)}); use pipeline_schedule='gpipe' for fsdp/tensor x "
                    "pipe meshes")

    def _setup_mesh(self, mesh):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a parallel.make_mesh mesh, not {type(mesh).__name__}")
        axes = {a: axis_of(mesh, a) for a in AXES}
        params = dict(self.model.core.named_parameters())
        self._specs = shard_params(params, mesh, heads=self.model.transformer_cfg.get("heads", 8))
        self._partial = [k for k in params if tensor_partial(k, self._specs)]
        if axes["fsdp"].size > 1 or axes["tensor"].size > 1:
            self._layout = (self._specs, axes)
        if self.pipeline_microbatches is None:  # a pipeline's stages take whole weights
            set_tensor_axis(self.model.core, axes["tensor"])
        self._axes = axes

    def init_state(self, params: Optional[dict] = None) -> TrainState:
        """Masters from `params` (a state dict, e.g. `weights.from_flax`'s;
        only the core's parameters are taken) or from the model's current
        weights, as float32 on the model's device (on a mesh: this rank's
        shards of them)."""
        names = [k for k, _ in self.model.core.named_parameters()]
        src = params if params is not None else dict(self.model.core.named_parameters())
        masters = {k: src[k].detach().to(device=self.model.device, dtype=torch.float32).clone()
                   for k in names}
        if self._axes is not None:
            masters = {k: shard_tensor(k, v, self._specs[k], self._axes)
                       for k, v in masters.items()}
        return TrainState(params=masters, opt_state=self.tx.init(masters),
                          ema=init_ema(masters), step=0)

    def _packed(self, batch):
        model = self.model
        if isinstance(batch, list):
            batch = model.pack(model.encode_modalities(batch), shift_friendly=True)
        if not isinstance(batch.text, torch.Tensor):
            batch = batch.to_torch(model.device)
        return batch

    def _microbatches(self, batch) -> list:
        """The grad_accumulation = M packed microbatches of one step: a
        ragged list of samples split by `np.array_split` into M and packed
        each, or a list of M packed batches. A single packed batch cannot be
        split by rows (its latent groups span the whole batch)."""
        M = self.grad_accumulation
        if isinstance(batch, PackedBatch):
            raise ValueError(
                "grad_accumulation needs the ragged batch (a list of samples) or a list "
                f"of {M} packed batches; a single packed batch cannot be split by rows "
                "because its latent groups are bucketed across the whole batch")
        if all(isinstance(b, PackedBatch) for b in batch):
            if len(batch) != M:
                raise ValueError(f"got {len(batch)} packed microbatches, expected "
                                 f"grad_accumulation={M}")
            return [self._packed(b) for b in batch]
        if len(batch) < M:
            raise ValueError(f"a batch of {len(batch)} samples cannot split into "
                             f"grad_accumulation={M} non-empty microbatches")
        return [self._packed([batch[i] for i in idx])
                for idx in np.array_split(np.arange(len(batch)), M)]

    def _grads(self, state: TrainState, packed, draws, loss_scales=None):
        """Loss, its parts (`_loss_parts`) and float32 gradients (a dict
        like the params) of one (micro)batch at the state's master weights;
        on a mesh, this rank's share reduced as the module docstring says
        (pipelined: the whole batch and whole weights on every rank, whose
        whole gradients the engines hand back; the rank keeps its shards)."""
        model, specs, axes = self.model, self._specs, self._axes
        params = state.params
        ema = state.ema.params if self.velocity_consistency else None
        pipeline = None
        if self.pipeline_microbatches is not None:
            pipeline = (self.mesh, self.pipeline_microbatches, self.pipeline_schedule)
            params = {k: unshard_tensor(k, v, specs[k], axes) for k, v in params.items()}
            if ema is not None:
                ema = {k: unshard_tensor(k, v, specs[k], axes) for k, v in ema.items()}
        elif axes is not None:
            packed, draws = batch_sharding(self.mesh, packed, draws)
            params = {k: gather_fsdp(v, specs[k], axes) for k, v in params.items()}
            if ema is not None:
                ema = {k: gather_fsdp(v, specs[k], axes) for k, v in ema.items()}
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with span("transfusion.train.forward"):
            loss, breakdown = model._loss_impl(
                leaves, packed, draws, model.prob_uncond, train=True, loss_scales=loss_scales,
                ema_params=ema, velocity_delta=self.velocity_delta, pipeline=pipeline)
        with span("transfusion.train.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        loss, parts = loss.detach(), self._loss_parts(breakdown)
        if pipeline is not None:
            grads = {k: shard_tensor(k, g, specs[k], axes) for k, g in grads.items()}
        elif axes is not None:
            with span("transfusion.train.reduce"):
                loss, parts, grads = self._reduce(loss, parts, grads)
        return loss, parts, grads

    def _reduce(self, loss, parts: dict, grads: dict):
        """A rank's loss share and tensor-local gradients -> the whole
        batch's loss and parts, and this rank's gradient shards."""
        ax = self._axes
        for k in self._partial:
            grads[k] = comm.all_reduce_sum(grads[k], ax["tensor"])
        grads = comm.all_reduce_dict(grads, ax["data"])
        for k, g in grads.items():
            spec = self._specs[k]
            if "fsdp" in spec:
                grads[k] = comm.reduce_scatter_sum(g, spec.index("fsdp"), ax["fsdp"]) / \
                    ax["fsdp"].size
        # the ranks that hold a replica of a shard computed its gradient each
        # on their own, and the card's attention backward adds dq with
        # atomics, so their last bits differ: their mean keeps the replicas
        # equal (on a 2-rank axis it is exact where they agree)
        for a in ("fsdp", "tensor"):
            rep = [k for k in grads if a not in self._specs[k]
                   and not (a == "tensor" and k in self._partial)]
            if ax[a].size > 1 and rep:
                mean = comm.all_reduce_dict({k: grads[k] for k in rep}, ax[a])
                grads.update({k: g / ax[a].size for k, g in mean.items()})
        sums = comm.all_reduce_sum(torch.stack([loss, *parts.values()]).float(), ax["data"])
        return sums[0], dict(zip(parts, sums[1:])), grads

    @staticmethod
    def _loss_parts(breakdown) -> dict:
        """A loss breakdown as metrics: text_loss, flow_loss_{i}, and
        velocity_loss_{i} / recon_loss_{i} when those terms are on."""
        parts = {"text_loss": breakdown.text.detach()}
        for name, losses in (("flow", breakdown.flow), ("velocity", breakdown.velocity),
                             ("recon", breakdown.recon)):
            for i, x in enumerate(losses or ()):
                parts[f"{name}_loss_{i}"] = x.detach()
        return parts

    def _apply(self, state: TrainState, grads, loss, parts: dict, tokens: int):
        """The update (fused, or the optimizer chain then the EMA); logs the
        metrics when `metrics_path` is set. Returns (new state, metrics). On
        a parameter-sharded mesh it runs inside `optim.sharded`."""
        with span("transfusion.train.update"), (
                contextlib.nullcontext() if self._layout is None
                else optim.sharded(*self._layout)):
            params, opt_state, ema, grad_norm = self._update(state, grads)
        new_state = TrainState(params=params, opt_state=opt_state, ema=ema, step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": grad_norm, **parts}
        if self.metrics is not None:
            with span("transfusion.train.log"):
                self.metrics.log(new_state.step, metrics, tokens=tokens)
        return new_state, metrics

    def _update(self, state: TrainState, grads):
        """(new params, optimizer state, EMA, grad_norm) from the step's
        gradients."""
        if self.fused_update:
            clipped = self.grad_clip_norm is not None
            adam = state.opt_state[1] if clipped else state.opt_state
            params, adam, ema_params, grad_norm = fused_clip_adam_ema(
                grads, state.params, adam, state.ema.params, state.ema.step,
                learning_rate=self.learning_rate, grad_clip_norm=self.grad_clip_norm,
                **{f"ema_{k}": v for k, v in self.ema_cfg.items()}, donate=self.donate_state,
            )
            opt_state = (state.opt_state[0], adam) if clipped else adam
            ema = EmaState(params=ema_params, step=state.ema.step + 1)
            return params, opt_state, ema, grad_norm
        grad_norm = optim.global_norm(grads)
        updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
        params = optim.apply_updates(state.params, updates)
        return params, opt_state, ema_update(state.ema, params, **self.ema_cfg), grad_norm

    def train_step(self, state: TrainState, batch, draws=None, generator=None):
        """One optimizer step on a ragged batch (list of samples) or a
        packed batch (with grad_accumulation: a ragged batch or a list of M
        packed ones, and draws a list of M `LossDraws`). Returns (new state,
        metrics): loss, grad_norm and `_loss_parts` (text_loss,
        flow_loss_{i}, velocity_loss_{i}, recon_loss_{i}), as 0-d tensors on
        the device."""
        if self.profiler is not None:
            self.profiler(state.step)
        with span("transfusion.train.step"):
            if self.grad_accumulation is not None:
                return self._train_step_accum(state, batch, draws, generator)
            with span("transfusion.train.batch"):
                packed = self._packed(batch)
            # a data-sharded step needs the whole batch's loss denominators
            sharded = self._axes is not None and self.pipeline_microbatches is None
            scales = None
            if draws is None or sharded:
                with span("transfusion.train.draws"):
                    if draws is None:
                        draws = self.model.make_draws(packed, generator,
                                                      velocity=self.velocity_consistency)
                    if sharded:
                        scales = self.model.loss_denominators(packed, draws)
            loss, parts, grads = self._grads(state, packed, draws, scales)
            return self._apply(state, grads, loss, parts, int(packed.total_tokens))

    def _train_step_accum(self, state: TrainState, batch, draws, generator):
        """Exact gradient accumulation (the JAX `_train_step_accum`,
        `trainer.py:315-406`): M microbatch forward and backward passes,
        each with the GLOBAL loss denominators (`loss_denominators` summed
        over the microbatches), their gradients summed in float32 in place,
        then one update. Loss and breakdown are summed the same way, so
        they equal the whole batch's."""
        model = self.model
        with span("transfusion.train.batch"):
            packs = self._microbatches(batch)
        with span("transfusion.train.draws"):
            if draws is None:
                draws = [model.make_draws(p, generator, velocity=self.velocity_consistency)
                         for p in packs]
            if len(draws) != len(packs):
                raise ValueError(f"{len(draws)} draws for {len(packs)} microbatches")
            scales = model.sum_loss_denominators(
                [model.loss_denominators(p, d) for p, d in zip(packs, draws)])
        loss = parts = grads = None
        for packed, d in zip(packs, draws):
            loss_m, parts_m, grads_m = self._grads(state, packed, d, scales)
            if grads is None:
                loss, parts, grads = loss_m, parts_m, grads_m
                continue
            with span("transfusion.train.reduce"):
                loss = loss + loss_m
                parts = {k: v + parts_m[k] for k, v in parts.items()}
                torch._foreach_add_(list(grads.values()), [grads_m[k] for k in grads])
            del grads_m  # not held through the next microbatch or the update
        return self._apply(state, grads, loss, parts, sum(int(p.total_tokens) for p in packs))

    def train_steps(self, state: TrainState, batches, steps: int, generator=None):
        """`steps` optimizer steps, each with fresh draws from `generator`:
        the per-step semantics of the JAX `train_steps` scan, as a Python
        loop. Without grad_accumulation, a list or tuple of packed batches
        is cycled (step i takes batches[i % len]) and must share one packed
        structure, as the JAX scan stacks them; one packed batch, or a
        ragged batch (a list of samples, packed once), is reused every
        step. With grad_accumulation, `batches` is one step's batch (a
        ragged list or M packed microbatches), reused every step. Returns
        (state, last metrics)."""
        if self.grad_accumulation is not None:
            packs = [self._microbatches(batches)]
        elif isinstance(batches, (list, tuple)) and any(
                isinstance(b, PackedBatch) for b in batches):
            packs = [self._packed(b) for b in batches]
            if len({_structure(p) for p in packs}) > 1:
                raise ValueError(
                    "train_steps batches must share one packed structure (same padded "
                    "length and same modality group shapes), as the JAX scan stacks them: "
                    "pack with a fixed pad_len and shape-bucketed modalities, or use "
                    "train_step per batch")
        else:
            packs = [self._packed(batches)]
        metrics = {}
        for i in range(steps):
            state, metrics = self.train_step(state, packs[i % len(packs)], generator=generator)
        return state, metrics

    def sync_model(self, state: TrainState):
        """Copy the state's master weights into the model's modules, in the
        model's dtype, for sampling with them (on a mesh: gathered whole,
        on every rank)."""
        params = self._unshard(state).params if self._axes is not None else state.params
        with torch.no_grad():
            for k, p in self.model.core.named_parameters():
                p.copy_(params[k])

    def _map_state(self, state: TrainState, fn) -> TrainState:
        """state with fn(name, tensor) applied to every parameter-shaped
        tensor: the params, the EMA and every optimizer state's."""
        names = frozenset(self._specs)
        return dataclasses.replace(
            state, params=_map_param_dicts(state.params, names, fn),
            opt_state=_map_param_dicts(state.opt_state, names, fn),
            ema=EmaState(params=_map_param_dicts(state.ema.params, names, fn),
                         step=state.ema.step))

    def _unshard(self, state: TrainState) -> TrainState:
        """The whole state from every rank's shards (a collective)."""
        return self._map_state(
            state, lambda k, v: unshard_tensor(k, v, self._specs[k], self._axes))

    def _shard(self, state: TrainState) -> TrainState:
        """This rank's shards of a whole state."""
        return self._map_state(
            state, lambda k, v: shard_tensor(k, v, self._specs[k], self._axes))

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _dir(self) -> str:
        if self.checkpoint_dir is None:
            raise ValueError("set checkpoint_dir to save or restore")
        return self.checkpoint_dir

    def save(self, state: TrainState) -> str:
        """Write `state` to checkpoint_dir/step_<step>.pt, with the core's
        persistent buffers (state the optimizer does not update, such as a
        router's selection bias); returns the path. On a mesh every rank
        calls it: the shards are gathered whole and rank 0 writes them."""
        path = os.path.join(self._dir(), f"step_{state.step}.pt")
        if self._axes is not None:
            state = self._unshard(state)
            if dist.get_rank() != 0:
                dist.barrier()
                return path
        os.makedirs(self._dir(), exist_ok=True)
        params = dict(self.model.core.named_parameters())
        torch.save({
            "params": state.params, "opt_state": state.opt_state, "ema": state.ema.params,
            "ema_step": state.ema.step, "step": state.step,
            "buffers": {k: v for k, v in self.model.core.state_dict().items()
                        if k not in params},
        }, path)
        if self._axes is not None:
            dist.barrier()
        return path

    def restore(self, step: Optional[int] = None) -> Optional[TrainState]:
        """The state saved at `step` (default: the latest), on the model's
        device, and the saved buffers copied into the core; None when there
        is no checkpoint."""
        found = [int(m[1]) for f in (os.listdir(self._dir()) if os.path.isdir(self._dir()) else ())
                 if (m := re.fullmatch(r"step_(\d+)\.pt", f))]
        if step is None and not found:
            return None
        step = max(found) if step is None else step
        path = os.path.join(self._dir(), f"step_{step}.pt")
        ck = torch.load(path, map_location=self.model.device, weights_only=True)
        with torch.no_grad():
            for name, buf in self.model.core.named_buffers():
                if name in ck.get("buffers", {}):
                    buf.copy_(ck["buffers"][name])
        state = TrainState(params=ck["params"], opt_state=ck["opt_state"],
                           ema=EmaState(params=ck["ema"], step=ck["ema_step"]), step=ck["step"])
        return state if self._axes is None else self._shard(state)
