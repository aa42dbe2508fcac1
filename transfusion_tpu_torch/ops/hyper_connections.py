"""Residual streams (counterpart of `transfusion_tpu/ops/hyper_connections.py`).

The port has the `streams == 1` case only, which is exactly a plain
residual `x + block(x)`. Multi-stream hyper-connections are queued in
ROADMAP.md ("multi-stream hyper-connections").
"""

from __future__ import annotations

from torch import nn


def _require_single(streams: int):
    if streams != 1:
        raise NotImplementedError(
            f"num_residual_streams={streams}: the port implements one residual "
            "stream only; multi-stream hyper-connections are queued in "
            "ROADMAP.md (Queue 1, 'multi-stream hyper-connections')"
        )


def expand_stream(x, streams: int = 1):
    _require_single(streams)
    return x[None]


def reduce_stream(s):
    _require_single(s.shape[0])
    return s[0]


class HyperConnection(nn.Module):
    """One block's read/write connection. Phase 1 (`branch_out` None)
    returns (branch input, streams); phase 2 adds the branch output back."""

    def __init__(self, streams: int = 1):
        super().__init__()
        _require_single(streams)

    def forward(self, s, branch_out=None):
        if branch_out is None:
            return s[0], s
        return s + branch_out[None]
