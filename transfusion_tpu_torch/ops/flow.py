"""Rectified-flow noising and output conversion, and text sampling filters
(counterpart of `transfusion_tpu/ops/flow.py`). Randomness comes from a caller-owned
`torch.Generator`; it cannot reproduce `jax.random` draws, so parity with
the JAX package is tested greedily or with injected noise."""

from __future__ import annotations

import torch

from transfusion_tpu_torch.ops.norms import safe_log


def _append_dims(t, ndims: int):
    return t.reshape(*t.shape, *((1,) * ndims))


def noise_data(data, noise, times):
    """x_t = t * x + (1 - t) * noise; flow target = x - noise. times
    broadcasts against data's leading dims. Returns (noised, flow)."""
    times = _append_dims(times, data.ndim - times.ndim)
    return data * times + noise * (1.0 - times), data - noise


def model_output_to_flow(out, noised, times, eps: float = 5e-2):
    """x-prediction -> flow: (x_hat - x_t) / max(1 - t, eps)."""
    noised = noised.reshape(out.shape)
    times = _append_dims(times, out.ndim - times.ndim)
    return (out - noised) / torch.clamp(1.0 - times, min=eps)


def min_p_filter(logits, min_p: float = 0.1):
    """Keep logits whose probability >= min_p * max probability, else -inf."""
    probs = torch.softmax(logits, dim=-1)
    limit = min_p * probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < limit, float("-inf"), logits)


def gumbel_noise(shape, generator=None, device=None):
    uniform = torch.rand(shape, generator=generator, device=device)
    uniform = uniform.clamp_min(1e-20)
    return -safe_log(-safe_log(uniform))


def gumbel_sample(logits, temperature: float = 1.0, generator=None, dim: int = -1):
    """argmax(logits / T + gumbel) — greedy when temperature == 0."""
    if temperature <= 0.0:
        return logits.argmax(dim=dim)
    noise = gumbel_noise(logits.shape, generator, logits.device)
    return (logits / temperature + noise).argmax(dim=dim)
