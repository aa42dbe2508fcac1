"""Token-major flash attention with fused RoPE — the training route of the
port (counterpart of `transfusion_tpu/ops/pallas_attn_kernel.py`
`flash_attention_nhd`: `_nhd_core` -> `_kernel_batched_nhd` forward and
`_bwd_kernel_batched_nhd` backward).

q, k, v stay in the projection's native layout [b, n, h*d]; the kernels
take a head's rows at a stride of h*d, so no transpose copies are made, and
rotate q/k by the interleaved RoPE as they load them (`csrc/flash_fwd.cu`
and `csrc/flash_bwd.cu` with nhd = 1). The forward also writes the
logsumexp, which the backward reads instead of recomputing the softmax.

On CPU tensors the plain versions run; on CUDA tensors the kernels, or an
error. `flash_attention_nhd.launches` and
`flash_attention_nhd_backward.launches` count kernel launches.
"""

from __future__ import annotations

import torch

from transfusion_tpu_torch.ops.flash_attn import (
    _MAX_HND_BATCHED,
    _MAX_N_TIMES_D_BWD,
    _MAX_SCORE_ELEMS_BWD,
    _device_kind,
    backward_plain_f32,
    flash_attention_plain,
    launch_bwd,
    launch_fwd,
)
from transfusion_tpu_torch.ops.rope import _rotate_half


def nhd_eligible(h: int, n: int, d: int) -> bool:
    """Does (h, n, d) take the token-major route (`nhd_eligible`,
    pallas_attn_kernel.py:1416)? The port follows the JAX predicate so that
    every layer takes the reference's route; outside it the head-major
    route runs."""
    return (
        d % 64 == 0
        and (h * d) % 128 == 0
        and n % 8 == 0
        and n >= 8
        and h * n * d <= _MAX_HND_BATCHED
        and n * n <= _MAX_SCORE_ELEMS_BWD
        and n * d <= _MAX_N_TIMES_D_BWD
    )


def _heads(t, h):
    """[b, n, h*d] -> [b, h, n, d]."""
    b, n, hd = t.shape
    return t.view(b, n, h, hd // h).transpose(1, 2)


def _tokens(t):
    """[b, h, n, d] -> [b, n, h*d]."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _rope_tokens(x, cos, sin, h, sign=1.0):
    """Interleaved RoPE over every head of x [b, n, h*d] in float32 with
    angles cos/sin [b|1, n, d] (`_rope_tile`); sign=-1 is the inverse."""
    cs, sn = cos.float().repeat(1, 1, h), sin.float().repeat(1, 1, h)
    x = x.float()
    return x * cs + _rotate_half(x) * (sign * sn)


def flash_attention_nhd_plain(q, k, v, h, cos=None, sin=None, spans=None, softcap=50.0):
    """Plain version of the forward kernel: q/k rotated in float32 and
    rounded to their dtype, then the head-major plain forward. Returns
    (out [b,n,h*d], lse float32 [b,h,n])."""
    if cos is not None:
        q = _rope_tokens(q, cos, sin, h).to(q.dtype)
        k = _rope_tokens(k, cos, sin, h).to(k.dtype)
    out, lse = flash_attention_plain(_heads(q, h), _heads(k, h), _heads(v, h), spans, softcap)
    return _tokens(out), lse


def flash_attention_nhd_backward_plain(q, k, v, do, lse, delta, h, cos=None, sin=None,
                                       spans=None, softcap=50.0, round_operands=None):
    """Plain version of the backward kernel on the token-major layout: q/k
    rotated as in the forward, the head-major backward arithmetic in
    float32 (`backward_plain_f32`, which also takes `round_operands`),
    dq/dk un-rotated with the negated sin, each rounded to its input's
    dtype."""
    qr, kr = q, k
    if cos is not None:
        qr = _rope_tokens(q, cos, sin, h).to(q.dtype)
        kr = _rope_tokens(k, cos, sin, h).to(k.dtype)
    dq, dk, dv = backward_plain_f32(_heads(qr, h), _heads(kr, h), _heads(v, h), _heads(do, h),
                                    lse, delta, spans, softcap, round_operands=round_operands)
    dq, dk, dv = _tokens(dq), _tokens(dk), _tokens(dv)
    if cos is not None:
        dq = _rope_tokens(dq, cos, sin, h, sign=-1.0)
        dk = _rope_tokens(dk, cos, sin, h, sign=-1.0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, h, cos, sin, spans, softcap):
    if _device_kind("flash_attention_nhd", q) == "cpu":
        return flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, softcap)
    out = launch_fwd(q, k, v, spans, softcap, 0, 0, True, heads=h, cos=cos, sin=sin)
    flash_attention_nhd.launches += 1
    return out


def flash_attention_nhd_backward(q, k, v, o, lse, do, h, cos=None, sin=None, spans=None,
                                 softcap=50.0):
    """Gradients (dq, dk, dv) [b,n,h*d] of `flash_attention_nhd` at output o
    (and the forward's lse) for the output cotangent do. delta =
    rowsum(do * o) per head is computed here in PyTorch."""
    b, n, hd = o.shape
    delta = (do.float() * o.float()).view(b, n, h, hd // h).sum(-1).transpose(1, 2)
    args = (q, k, v, do, lse, delta)
    if _device_kind("flash_attention_nhd backward", q) == "cpu":
        return flash_attention_nhd_backward_plain(*args, h, cos, sin, spans, softcap)
    out = launch_bwd(*args, spans, softcap, 0, 0, heads=h, cos=cos, sin=sin)
    flash_attention_nhd_backward.launches += 1
    return out


class _FlashAttentionNHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, h, cos, sin, spans, softcap):
        out, lse = _forward(q, k, v, h, cos, sin, spans, softcap)
        ctx.save_for_backward(q, k, v, cos, sin, spans, out, lse)
        ctx.cfg = (h, softcap)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, spans, out, lse = ctx.saved_tensors
        h, softcap = ctx.cfg
        dq, dk, dv = flash_attention_nhd_backward(q, k, v, out, lse, g, h, cos, sin, spans,
                                                  softcap)
        # cos/sin derive from integer positions: their cotangents are zero
        return dq, dk, dv, None, None, None, None, None


def flash_attention_nhd(q, k, v, h, cos=None, sin=None, spans=None, causal=False,
                        softcap=50.0):
    """Fused-layout flash attention: q, k, v [b, n, h*d]; rotary applied in
    the kernel from cos/sin Float[b|1, n, d] (None = no rotary). Returns out
    [b, n, h*d]. Mask semantics as `flash_attention` (causal | spans, tanh
    softcap). Callers check `nhd_eligible(h, n, d)`; this raises outside it.
    Differentiable in q, k, v."""
    b, n, hd = q.shape
    if hd % h or not nhd_eligible(h, n, hd // h):
        raise ValueError(f"flash_attention_nhd: (h, n, d) = {(h, n, hd // h)} not eligible")
    if spans is None and not causal:
        raise ValueError("flash_attention_nhd needs causal=True and/or spans")
    if (cos is None) != (sin is None):
        raise ValueError("flash_attention_nhd: give both cos and sin, or neither")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionNHD.apply(q, k, v, h, cos, sin, spans, softcap)
    return _forward(q, k, v, h, cos, sin, spans, softcap)[0]


flash_attention_nhd.launches = 0
flash_attention_nhd_backward.launches = 0
