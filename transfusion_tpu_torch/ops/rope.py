"""Rotary position embeddings, interleaved convention (counterpart of
`transfusion_tpu/ops/rope.py`).

    freqs_j = theta ** (-2j / d),  j in [0, d/2)
    angle[..., 2j] = angle[..., 2j+1] = pos * freqs_j
    rotate_half(x)[..., 2j]   = -x[..., 2j+1]
    rotate_half(x)[..., 2j+1] =  x[..., 2j]
    out = x * cos(angle) + rotate_half(x) * sin(angle)
"""

from __future__ import annotations

import torch


def rope_angles(positions, dim_head: int, theta: float = 10000.0):
    """positions Int/Float[...] -> angles Float32[..., dim_head]."""
    assert dim_head % 2 == 0
    exps = torch.arange(0, dim_head, 2, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (exps / dim_head))
    angles = positions.to(torch.float32)[..., None] * freqs
    return angles.repeat_interleave(2, dim=-1)


def _rotate_half(x):
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rope(angles, t):
    """angles Float[..., n', d] broadcastable to t Float[..., n, d]; when
    n' > n the last n positions are used. Computed in float32, returned in
    t's dtype."""
    seq_len = t.shape[-2]
    if angles.shape[-2] > seq_len:
        angles = angles[..., -seq_len:, :]
    angles = angles.to(torch.float32)
    t32 = t.to(torch.float32)
    out = t32 * torch.cos(angles) + _rotate_half(t32) * torch.sin(angles)
    return out.to(t.dtype)
