"""Elementwise numeric primitives (counterpart of `transfusion_tpu/ops/norms.py`)."""

from __future__ import annotations

import torch

# the attention kernels' additive "minus infinity": finite, so a fully
# masked row never produces inf - inf
NEG_INF = -1e30


def l2norm(t, dim: int = -1, eps: float = 1e-12):
    """x / max(||x||_2, eps) along `dim`."""
    return t / t.norm(dim=dim, keepdim=True).clamp_min(eps)


def softclamp(t, value: float = 50.0):
    """tanh soft clamp: tanh(t / v) * v."""
    return torch.tanh(t / value) * value


def safe_log(t, eps: float = 1e-20):
    return torch.log(t.clamp_min(eps))


def max_neg_value(dtype=torch.float32) -> float:
    return -torch.finfo(dtype).max
