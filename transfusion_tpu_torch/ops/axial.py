"""Continuous axial positional embeddings (counterpart of
`transfusion_tpu/ops/axial.py`): an MLP maps each sequence row's axial
coordinates (Float[..., num_axial_dims]) to a positional embedding, so
every spatial size shares one set of parameters."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ContinuousAxialPositionalEmbedding(nn.Module):
    """Three dense layers, `dim * expansion` wide, with SiLU between them;
    `layers.{j}` carries flax's `Dense_{j}`."""

    def __init__(self, dim: int, num_axial_dims: int, expansion: int = 2):
        super().__init__()
        hidden = dim * expansion
        self.num_axial_dims = num_axial_dims
        self.layers = nn.ModuleList([
            nn.Linear(num_axial_dims, hidden), nn.Linear(hidden, hidden), nn.Linear(hidden, dim),
        ])

    def forward(self, coords):
        """coords Float[..., num_axial_dims] -> Float[..., dim], in the
        layers' dtype (the coordinates are float32 going in)."""
        h = coords.to(torch.float32).to(self.layers[0].weight.dtype)
        h = F.silu(self.layers[0](h))
        h = F.silu(self.layers[1](h))
        return self.layers[2](h)

    @staticmethod
    def coords_for_shape(shape: tuple, num_axial_dims: int, device=None):
        """The dense coordinate grid Float[prod(shape), num_axial_dims] in
        row-major order. A 0-d shape gives one zero row; a shape shorter
        than num_axial_dims is right-padded with zero axes."""
        if len(shape) == 0:
            return torch.zeros((1, num_axial_dims), device=device)
        axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, len(shape))
        if len(shape) < num_axial_dims:
            grid = F.pad(grid, (0, num_axial_dims - len(shape)))
        return grid
