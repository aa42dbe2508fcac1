"""Span metadata ops (counterpart of `transfusion_tpu/ops/spans.py`).

A batch's modality layout is `spans: Int[b, m, 3]` holding
`(modality_type, offset, length)` triples, zero-padded (length <= 0 rows
are inert).
"""

from __future__ import annotations

import torch


def spans_to_instance_mask(seq_len: int, spans):
    """Bool[b, m, n]: token j belongs to span instance m."""
    offsets = spans[..., 1:2]
    lengths = spans[..., 2:3]
    pos = torch.arange(seq_len, device=spans.device)[None, None, :]
    return (pos >= offsets) & (pos < offsets + lengths)


def spans_to_modality_mask(seq_len: int, spans, num_modalities: int = 1):
    """Bool[b, t, m, n]: the instance mask split per modality type."""
    inst = spans_to_instance_mask(seq_len, spans)  # [b, m, n]
    types = torch.arange(num_modalities, device=spans.device)
    type_match = spans[..., 0][:, None, :] == types[None, :, None]  # [b, t, m]
    return type_match[..., None] & inst[:, None]


def spans_to_is_any_modality(seq_len: int, spans):
    """Bool[b, n]: token is inside any modality span."""
    return spans_to_instance_mask(seq_len, spans).any(dim=1)


def span_allowed(rows, cols, spans):
    """THE transfusion mask at given global coordinates:

        allowed(i, j) = (i >= j) | any_m[len_m > 0 & i >= off_m & j < off_m + len_m]

    rows Int[nq], cols Int[nkv], spans Int[b, m, 3] | None -> Bool[b|1, nq, nkv].
    Every attention path (plain and CUDA) evaluates exactly this."""
    allowed = (rows[:, None] >= cols[None, :])[None]
    if spans is None:
        return allowed
    off = spans[..., 1][:, :, None, None]  # [b, m, 1, 1]
    ln = spans[..., 2][:, :, None, None]
    rect = (ln > 0) & (rows[None, None, :, None] >= off) & (
        cols[None, None, None, :] < off + ln
    )
    return allowed | rect.any(dim=1)


def spans_to_attn_mask(seq_len: int, spans):
    """Bool[b, i, j] transfusion mask: causal OR any modality rectangle."""
    seq = torch.arange(seq_len, device=spans.device)
    return span_allowed(seq, seq, spans)


def spans_to_rotary_positions(seq_len: int, spans):
    """Int[b, n] rotary position ids with modality interiors collapsed: the
    span is shrunk by (+1, -1) and positions are arange(n) minus the running
    count of shrunk-span tokens."""
    shrunk = torch.cat(
        [spans[..., 0:1], spans[..., 1:2] + 1, spans[..., 2:3] - 1], dim=-1
    )
    is_any = spans_to_is_any_modality(seq_len, shrunk)
    seq = torch.arange(seq_len, device=spans.device)[None, :]
    return seq - torch.cumsum(is_any.to(torch.int64), dim=-1)
