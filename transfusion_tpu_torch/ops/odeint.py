"""ODE integrators (counterpart of `transfusion_tpu/ops/odeint.py`).

Fixed-grid solvers take one `method` step between each adjacent pair of
grid points, as torchdiffeq's fixed-grid solvers do; the grid and the step
sizes are float32 scalars so the arithmetic on times matches the JAX scan.
`method="adaptive"` integrates with tolerance-controlled Heun steps
(`odeint_adaptive`); `odeint_adaptive_rows` gives each row of a batch its
own step controller. The JAX `lax.while_loop`s become Python loops whose
state stays on the device: each iteration reads one flag back to the host.
"""

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


def _scalar(x, device):
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def odeint_adaptive(fn: Callable, y0, t0, t1, atol: float = 1e-5, rtol: float = 1e-5,
                    max_steps: int = 4096):
    """Tolerance-controlled adaptive Heun integration of dy/dt = fn(t, y)
    from t0 to t1 (JAX `odeint_adaptive`, `ops/odeint.py:61-140`).

    Each step is a Heun step with its embedded Euler predictor as the error
    estimate; it is accepted when max|heun - euler| <= atol + rtol *
    max|y|, and the step size follows 0.9 * ratio^(-1/2) clipped to
    [0.2, 5]. `t` reaches `fn` as a 0-d float32 tensor on y0's device. One
    flag (t short of t1) is read back per iteration; if max_steps runs out,
    one explicit Euler step closes the gap to t1."""
    dev = y0.device
    t1 = _scalar(t1, dev)
    t = _scalar(t0, dev)
    span = t1 - t
    end = t1 - 1e-7 * span.abs()
    y, dt = y0, span / 16.0
    n = 0
    while n < max_steps and bool(t < end):
        dt = torch.minimum(dt, t1 - t)
        k1 = fn(t, y)
        k2 = fn(t + dt, y + dt * k1)
        y_heun = y + dt * 0.5 * (k1 + k2)
        err = ((k1 - k2) * (dt * 0.5)).float().abs().amax()
        tol = atol + rtol * y.float().abs().amax()
        ratio = err / tol.clamp_min(1e-30)
        accept = ratio <= 1.0
        y = torch.where(accept, y_heun, y)
        t = torch.where(accept, t + dt, t)
        factor = (0.9 * torch.rsqrt(ratio.clamp_min(1e-10))).clamp(0.2, 5.0)
        dt = torch.maximum(dt * factor, 1e-5 * span.abs())
        n += 1
    gap = t1 - t
    if bool(gap.abs() > 1e-6 * span.abs()):
        y = y + gap * fn(t, y)
    return y


def odeint_adaptive_rows(fn: Callable, y0, t0, t1, atol: float = 1e-5, rtol: float = 1e-5,
                         max_steps: int = 4096):
    """Per-row tolerance-adaptive Heun (JAX `odeint_adaptive_rows`,
    `ops/odeint.py:143-235`): y0 [b, ...] holds b independent problems and
    `fn(t, y)` takes a per-row time vector t Float32[b]. Every row has its
    own (t, dt, accept) controller, so a row's steps depend only on its own
    error estimates; a finished row has dt clamped to 0, which makes its
    step a no-op while the loop drives the others. One flag (any row short
    of t1) is read back per iteration.

    The closing Euler step after max_steps runs out is gated batch-wide, as
    the reference's `jnp.any` gate is (`ops/odeint.py:230-235`): when one
    row exhausts max_steps, every row takes the closing step with its own
    gap (0 for finished rows, so a finished row's value changes only by
    0 * fn). The port matches this on purpose; a per-row gate would differ
    from the reference exactly there."""
    b = y0.shape[0]
    dev = y0.device
    t1v = _scalar(t1, dev).expand(b)
    t = _scalar(t0, dev).expand(b).clone()
    span = t1v - t
    end = t1v - 1e-7 * span.abs()

    def rows(v):
        return v.reshape((b,) + (1,) * (y0.ndim - 1))

    def row_max_abs(x):
        return x.float().abs().reshape(b, -1).amax(dim=1)

    y, dt = y0, span / 16.0
    n = 0
    while n < max_steps and bool((t < end).any()):
        dt = torch.minimum(dt, t1v - t)
        k1 = fn(t, y)
        k2 = fn(t + dt, y + rows(dt) * k1)
        y_heun = y + rows(dt * 0.5) * (k1 + k2)
        err = row_max_abs((k1 - k2) * rows(dt * 0.5))
        tol = atol + rtol * row_max_abs(y)
        ratio = err / tol.clamp_min(1e-30)
        accept = ratio <= 1.0
        y = torch.where(rows(accept), y_heun, y)
        t = torch.where(accept, t + dt, t)
        factor = (0.9 * torch.rsqrt(ratio.clamp_min(1e-10))).clamp(0.2, 5.0)
        dt = torch.maximum(dt * factor, 1e-5 * span.abs())
        n += 1
    gap = t1v - t
    if bool((gap.abs() > 1e-6 * span.abs()).any()):
        y = y + rows(gap) * fn(t, y)
    return y


def odeint(fn: Callable, y0, times, method: str = "midpoint", atol: float = 1e-5,
           rtol: float = 1e-5):
    """Integrate dy/dt = fn(t, y) across the grid `times` Float[T]; returns
    y(times[-1]). Fixed-grid methods hand `t` to `fn` as a 0-d float32 CPU
    tensor; `method="adaptive"` integrates times[0] -> times[-1] with
    `odeint_adaptive` (atol, rtol) and hands `t` over on y0's device."""
    times = torch.as_tensor(times, dtype=torch.float32).cpu()
    if method == "adaptive":
        return odeint_adaptive(fn, y0, times[0], times[-1], atol=atol, rtol=rtol)
    if method not in _STEPPERS:
        raise ValueError(f"odeint method {method!r} (one of {sorted(_STEPPERS)} or 'adaptive')")
    stepper = _STEPPERS[method]
    y = y0
    for i in range(times.shape[0] - 1):
        y = stepper(fn, times[i], times[i + 1] - times[i], y)
    return y
