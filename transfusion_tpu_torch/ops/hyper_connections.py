"""Multi-stream residuals, hyper-connections (counterpart of
`transfusion_tpu/ops/hyper_connections.py`).

The residual state is `streams` parallel copies S [s, b, n, d] of the
token stream. Each block reads a softmax-weighted mix of the streams
(static logits plus a token-dependent part from the l2-normalized streams),
the streams are mixed by a row-stochastic matrix, and the block's output is
written back with learned per-stream weights. `fracs` splits the channels
into groups with their own weights. `streams == 1` is exactly the plain
residual `x + block(x)` and has no parameters.

The parameters are float32 whatever the model's dtype (the JAX module has
no `dtype`), and every product promotes, as flax's einsums do: in a bf16
model the streams are float32 from the first block on.
"""

from __future__ import annotations

import torch
from torch import nn

from transfusion_tpu_torch.ops.norms import l2norm


def expand_stream(x, streams: int = 1):
    """[b, n, d] -> [s, b, n, d]."""
    if streams == 1:
        return x[None]
    return x[None].expand(streams, *x.shape)


def reduce_stream(s):
    """[s, b, n, d] -> [b, n, d], the mean of the streams."""
    if s.shape[0] == 1:
        return s[0]
    return s.mean(dim=0)


def _einsum(eq, a, b):
    """torch.einsum on the operands' promoted dtype (jnp.einsum promotes)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


class HyperConnection(nn.Module):
    """One block's read / mix / write connection over `streams` streams,
    anchored at stream `layer_index % streams`. Phase 1 (`branch_out`
    None) returns (branch input [b, n, d], mixed streams [s, b, n, d]);
    phase 2 adds the branch output back into the streams."""

    def __init__(self, dim: int, streams: int = 1, fracs: int = 1, layer_index: int = 0):
        super().__init__()
        self.dim, self.streams, self.fracs = dim, streams, fracs
        if streams == 1:
            return
        if dim % fracs:
            raise ValueError(f"num_residual_fracs={fracs} must divide dim {dim}")
        anchor = torch.eye(streams)[layer_index % streams].repeat(fracs, 1)  # [f, s]
        self.alpha_logit = nn.Parameter(4.0 * anchor)
        self.beta = nn.Parameter(anchor.clone())
        self.mix_logit = nn.Parameter(4.0 * torch.eye(streams).repeat(fracs, 1, 1))  # [f, s, s]
        self.alpha_dyn_kernel = nn.Parameter(torch.zeros(fracs, dim // fracs))
        self.alpha_dyn_scale = nn.Parameter(torch.full((fracs,), 1e-2))

    def _split(self, t):  # [..., d] -> [..., f, d / f]
        return t.reshape(*t.shape[:-1], self.fracs, self.dim // self.fracs)

    def forward(self, s, branch_out=None):
        if self.streams == 1:
            if branch_out is None:
                return s[0], s
            return s + branch_out[None]
        if branch_out is not None:
            write = _einsum("fs,bnfc->sbnfc", self.beta, self._split(branch_out))
            return s + write.flatten(-2)
        sf = self._split(s)  # [s, b, n, f, d / f]
        dyn = torch.tanh(_einsum("sbnfc,fc->sbnf", l2norm(sf), self.alpha_dyn_kernel))
        logits = self.alpha_logit.T[:, None, None, :] + dyn * self.alpha_dyn_scale
        weights = torch.softmax(logits, dim=0)  # over the streams
        branch = _einsum("sbnfc,sbnf->bnfc", sf, weights).flatten(-2)
        mix = torch.softmax(self.mix_logit, dim=-1)  # [f, s_out, s_in]
        mixed = _einsum("fos,sbnfc->obnfc", mix, sf).flatten(-2)
        return branch, mixed
