"""Exponential moving average of the parameters (counterpart of
`transfusion_tpu/training/ema.py`): copy until warm-up ends, then blend
every `update_every` steps, as ema-pytorch schedules it. Parameters are
dicts of tensors (state-dict names); every function returns new tensors."""

from __future__ import annotations

import dataclasses


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
