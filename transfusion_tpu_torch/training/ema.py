"""Exponential moving average of the parameters (counterpart of
`transfusion_tpu/training/ema.py`): copy until warm-up ends, then blend
every `update_every` steps, as ema-pytorch schedules it. Parameters are
dicts of tensors (state-dict names); every function returns new tensors.
`EMA` (`Transfusion.create_ema`) holds the state and runs the model's
samplers on the EMA weights."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EmaState:
    params: dict
    step: int


def init_ema(params: dict) -> EmaState:
    """A fresh copy of params (it must not alias the live weights)."""
    return EmaState(params={k: p.detach().clone() for k, p in params.items()}, step=0)


def ema_update(state: EmaState, params: dict, beta: float = 0.99, update_every: int = 10,
               update_after_step: int = 100) -> EmaState:
    step = state.step + 1
    if step <= update_after_step:
        new = {k: p.detach().clone() for k, p in params.items()}
    elif step % update_every == 0:
        new = {k: state.params[k] * beta + p.detach() * (1.0 - beta) for k, p in params.items()}
    else:
        new = state.params
    return EmaState(params=new, step=step)


class EMA:
    """`ema = model.create_ema()`; `ema.update(params)` after each step;
    `ema.sample(...)`, `ema.generate_text_only(...)` and
    `ema.generate_modality_only(...)` run the model on the EMA weights and
    leave its own weights as they were."""

    def __init__(self, model, params: dict, beta: float = 0.99, update_every: int = 10,
                 update_after_step: int = 100):
        self.model = model
        self.cfg = dict(beta=beta, update_every=update_every,
                        update_after_step=update_after_step)
        self.state = init_ema(params)

    @property
    def ema_params(self) -> dict:
        return self.state.params

    def update(self, params: dict) -> EmaState:
        self.state = ema_update(self.state, params, **self.cfg)
        return self.state

    @contextlib.contextmanager
    def _swapped(self):
        """The model's core holds the EMA weights (in its own dtypes) while
        open; its weights are put back on exit."""
        live = dict(self.model.core.named_parameters())
        saved = {k: p.detach().clone() for k, p in live.items()}
        with torch.no_grad():
            for k, p in self.ema_params.items():
                live[k].copy_(p)
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in saved.items():
                    live[k].copy_(p)

    def sample(self, *args, **kwargs):
        with self._swapped():
            return self.model.sample(*args, **kwargs)

    def generate_text_only(self, *args, **kwargs):
        with self._swapped():
            return self.model.generate_text_only(*args, **kwargs)

    def generate_modality_only(self, *args, **kwargs):
        with self._swapped():
            return self.model.generate_modality_only(*args, **kwargs)
