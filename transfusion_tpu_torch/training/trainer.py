"""Trainer: the joint training step with gradient clipping, an optimizer
and the EMA, metrics, a profiler window and checkpoints (counterpart of
`transfusion_tpu/training/trainer.py`).

The optimizer is `chain(clip_by_global_norm(grad_clip_norm), optimizer)`
(`training/optim.py`; `optimizer` defaults to `adam(learning_rate)`). With
the default optimizer and a constant learning rate the step takes the fused
clip + Adam + EMA pass (`training/fused_update.py`; `fused_update=`
overrides), else `update` -> `apply_updates` -> `ema_update`; grad_norm is
the global norm of the raw gradients either way.

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
(`ProfilerHook`).

Randomness: `train_step` takes the loss's draws (`LossDraws`, or a list of
M of them) or makes them from a `torch.Generator`. Not ported yet
(ROADMAP.md): meshes, pipeline parallelism.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from transfusion_tpu_torch.data.packing import PackedBatch
from transfusion_tpu_torch.training import optim
from transfusion_tpu_torch.training.ema import EmaState, ema_update, init_ema
from transfusion_tpu_torch.training.fused_update import fused_clip_adam_ema
from transfusion_tpu_torch.training.metrics import MetricsLogger, ProfilerHook


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict  # float32 master weights
    opt_state: Any  # the optimizer chain's state (`training/optim.py`)
    ema: EmaState
    step: int


def _queued(what: str, item: str):
    raise NotImplementedError(f"{what} is not in the PyTorch port yet (ROADMAP.md: {item})")


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
                 grad_accumulation: Optional[int] = None,
                 fused_update: Optional[bool] = None):
        if mesh is not None:
            _queued("mesh sharding", "Queue 1 item 9, parallelism")
        if pipeline_microbatches is not None:
            _queued("pipeline parallelism", "Queue 1 item 9, parallelism")
        if grad_accumulation is not None and grad_accumulation < 2:
            raise ValueError("grad_accumulation must be >= 2 (None disables it)")
        if fused_update is None:
            fused_update = optimizer is None and isinstance(learning_rate, (int, float))
        if fused_update and optimizer is not None:
            raise ValueError("fused_update runs clip + Adam only; it takes no optimizer")
        self.model = model
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

    def init_state(self, params: Optional[dict] = None) -> TrainState:
        """Masters from `params` (a state dict, e.g. `weights.from_flax`'s;
        only the core's parameters are taken) or from the model's current
        weights, as float32 on the model's device."""
        names = [k for k, _ in self.model.core.named_parameters()]
        src = params if params is not None else dict(self.model.core.named_parameters())
        masters = {k: src[k].detach().to(device=self.model.device, dtype=torch.float32).clone()
                   for k in names}
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
        """Loss, breakdown and float32 gradients (a dict like the params) of
        one (micro)batch at the state's master weights."""
        model = self.model
        leaves = {k: p.detach().requires_grad_(True) for k, p in state.params.items()}
        loss, breakdown = model._loss_impl(
            leaves, packed, draws, model.prob_uncond, train=True, loss_scales=loss_scales,
            ema_params=state.ema.params if self.velocity_consistency else None,
            velocity_delta=self.velocity_delta)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(state.params.items(), grads)}
        return loss.detach(), breakdown, grads

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
        metrics when `metrics_path` is set. Returns (new state, metrics)."""
        if self.fused_update:
            clipped = self.grad_clip_norm is not None
            adam = state.opt_state[1] if clipped else state.opt_state
            params, adam, ema_params, grad_norm = fused_clip_adam_ema(
                grads, state.params, adam, state.ema.params, state.ema.step,
                learning_rate=self.learning_rate, grad_clip_norm=self.grad_clip_norm,
                **{f"ema_{k}": v for k, v in self.ema_cfg.items()},
            )
            opt_state = (state.opt_state[0], adam) if clipped else adam
            ema = EmaState(params=ema_params, step=state.ema.step + 1)
        else:
            grad_norm = optim.global_norm(grads)
            updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
            params = optim.apply_updates(state.params, updates)
            ema = ema_update(state.ema, params, **self.ema_cfg)
        new_state = TrainState(params=params, opt_state=opt_state, ema=ema, step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": grad_norm, **parts}
        if self.metrics is not None:
            self.metrics.log(new_state.step, metrics, tokens=tokens)
        return new_state, metrics

    def train_step(self, state: TrainState, batch, draws=None, generator=None):
        """One optimizer step on a ragged batch (list of samples) or a
        packed batch (with grad_accumulation: a ragged batch or a list of M
        packed ones, and draws a list of M `LossDraws`). Returns (new state,
        metrics): loss, grad_norm and `_loss_parts` (text_loss,
        flow_loss_{i}, velocity_loss_{i}, recon_loss_{i}), as 0-d tensors on
        the device."""
        if self.profiler is not None:
            self.profiler(state.step)
        if self.grad_accumulation is not None:
            return self._train_step_accum(state, batch, draws, generator)
        packed = self._packed(batch)
        if draws is None:
            draws = self.model.make_draws(packed, generator, velocity=self.velocity_consistency)
        loss, breakdown, grads = self._grads(state, packed, draws)
        return self._apply(state, grads, loss, self._loss_parts(breakdown),
                           int(packed.total_tokens))

    def _train_step_accum(self, state: TrainState, batch, draws, generator):
        """Exact gradient accumulation (the JAX `_train_step_accum`,
        `trainer.py:315-406`): M microbatch forward and backward passes,
        each with the GLOBAL loss denominators (`loss_denominators` summed
        over the microbatches), their gradients summed in float32 in place,
        then one update. Loss and breakdown are summed the same way, so
        they equal the whole batch's."""
        model = self.model
        packs = self._microbatches(batch)
        if draws is None:
            draws = [model.make_draws(p, generator, velocity=self.velocity_consistency)
                     for p in packs]
        if len(draws) != len(packs):
            raise ValueError(f"{len(draws)} draws for {len(packs)} microbatches")
        scales = model.sum_loss_denominators(
            [model.loss_denominators(p, d) for p, d in zip(packs, draws)])
        loss = parts = grads = None
        for packed, d in zip(packs, draws):
            loss_m, bd, grads_m = self._grads(state, packed, d, scales)
            parts_m = self._loss_parts(bd)
            if grads is None:
                loss, parts, grads = loss_m, parts_m, grads_m
                continue
            loss = loss + loss_m
            parts = {k: v + parts_m[k] for k, v in parts.items()}
            torch._foreach_add_(list(grads.values()), [grads_m[k] for k in grads])
            del grads_m  # not held through the next microbatch or the update
        return self._apply(state, grads, loss, parts, sum(int(p.total_tokens) for p in packs))

    def train_steps(self, state: TrainState, batch, steps: int, generator=None):
        """`steps` optimizer steps on one batch (packed once), each with
        fresh draws from `generator`: the per-step semantics of the JAX
        `train_steps` scan, as a Python loop. Returns (state, last metrics)."""
        packed = (self._microbatches(batch) if self.grad_accumulation is not None
                  else self._packed(batch))
        metrics = {}
        for _ in range(steps):
            state, metrics = self.train_step(state, packed, generator=generator)
        return state, metrics

    def sync_model(self, state: TrainState):
        """Copy the state's master weights into the model's modules, in the
        model's dtype, for sampling with them."""
        with torch.no_grad():
            for k, p in self.model.core.named_parameters():
                p.copy_(state.params[k])

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _dir(self) -> str:
        if self.checkpoint_dir is None:
            raise ValueError("set checkpoint_dir to save or restore")
        return self.checkpoint_dir

    def save(self, state: TrainState) -> str:
        """Write `state` to checkpoint_dir/step_<step>.pt; returns the path."""
        os.makedirs(self._dir(), exist_ok=True)
        path = os.path.join(self._dir(), f"step_{state.step}.pt")
        torch.save({
            "params": state.params, "opt_state": state.opt_state, "ema": state.ema.params,
            "ema_step": state.ema.step, "step": state.step,
        }, path)
        return path

    def restore(self, step: Optional[int] = None) -> Optional[TrainState]:
        """The state saved at `step` (default: the latest), on the model's
        device; None when there is no checkpoint."""
        found = [int(m[1]) for f in (os.listdir(self._dir()) if os.path.isdir(self._dir()) else ())
                 if (m := re.fullmatch(r"step_(\d+)\.pt", f))]
        if step is None and not found:
            return None
        step = max(found) if step is None else step
        path = os.path.join(self._dir(), f"step_{step}.pt")
        ck = torch.load(path, map_location=self.model.device, weights_only=True)
        return TrainState(params=ck["params"], opt_state=ck["opt_state"],
                          ema=EmaState(params=ck["ema"], step=ck["ema_step"]), step=ck["step"])
