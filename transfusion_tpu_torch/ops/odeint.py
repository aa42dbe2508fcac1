"""Fixed-grid ODE integrators (counterpart of the fixed-grid part of
`transfusion_tpu/ops/odeint.py`). One `method` step is taken between each
adjacent pair of grid points, as torchdiffeq's fixed-grid solvers do. The
grid and the step sizes are float32 scalars so the arithmetic on times
matches the JAX scan."""

from __future__ import annotations

from typing import Callable

import torch


def _euler_step(fn, t0, dt, y):
    return y + dt * fn(t0, y)


def _midpoint_step(fn, t0, dt, y):
    half = dt * 0.5
    k1 = fn(t0, y)
    k2 = fn(t0 + half, y + half * k1)
    return y + dt * k2


def _heun_step(fn, t0, dt, y):
    k1 = fn(t0, y)
    k2 = fn(t0 + dt, y + dt * k1)
    return y + dt * 0.5 * (k1 + k2)


def _rk4_step(fn, t0, dt, y):
    half = dt * 0.5
    k1 = fn(t0, y)
    k2 = fn(t0 + half, y + half * k1)
    k3 = fn(t0 + half, y + half * k2)
    k4 = fn(t0 + dt, y + dt * k3)
    return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}


def odeint(fn: Callable, y0, times, method: str = "midpoint"):
    """Integrate dy/dt = fn(t, y) across the grid `times` Float[T]; returns
    y(times[-1]). `t` is handed to `fn` as a 0-d float32 CPU tensor."""
    if method not in _STEPPERS:
        raise NotImplementedError(
            f"odeint method {method!r}: the port has the fixed-grid solvers "
            f"{sorted(_STEPPERS)}; adaptive solvers are queued in ROADMAP.md"
        )
    stepper = _STEPPERS[method]
    times = torch.as_tensor(times, dtype=torch.float32).cpu()
    y = y0
    for i in range(times.shape[0] - 1):
        y = stepper(fn, times[i], times[i + 1] - times[i], y)
    return y
