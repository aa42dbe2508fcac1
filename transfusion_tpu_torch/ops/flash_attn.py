"""Flash-attention forward with the transfusion mask — kernel 1 of the port.

Counterpart of `transfusion_tpu/ops/pallas_attn_kernel.py` `flash_attention`
(the head-major forward `_flash_fwd` -> `_kernel_batched_heads` / `_kernel`
/ `_kernel_streamed`). The CUDA kernel is `csrc/flash_fwd.cu`; its source
note says what bounds it on the H100 and what the design does about it.

`flash_attention` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (there is no fallback between the
two). `flash_attention.launches` counts kernel launches.

Mask contract (global coordinates i = q_offset + row, j = kv_offset + col):

    allowed(i, j) = i >= j | any_m[len_m > 0 & i >= off_m & j < off_m + len_m]

with a tanh softcap on the logits after the d^-1/2 scale. A row that sees
no column returns 0 and logsumexp ~ -1e30.
"""

from __future__ import annotations

import ctypes

import torch

from transfusion_tpu_torch.ops import _build
from transfusion_tpu_torch.ops.norms import NEG_INF
from transfusion_tpu_torch.ops.spans import span_allowed

MAX_SPANS = 128  # csrc/flash_fwd.cu keeps a block's spans in shared memory
HEAD_DIMS = (32, 64, 128)
# flash_fwd(q, k, v, spans, m, out, lse, b, h, nq, nkv, d, q_off, kv_off,
#           scale, softcap, is_bf16, stream)
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
)


def flash_attention_plain(q, k, v, spans=None, softcap=50.0, q_offset=0, kv_offset=0):
    """Dense PyTorch version of the kernel's arithmetic. Returns
    (out [b,h,nq,d] in q's dtype, lse float32 [b,h,nq])."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    scale = torch.tensor(d**-0.5, dtype=q.dtype)
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    rows = torch.arange(nq, device=q.device) + int(q_offset)
    cols = torch.arange(nkv, device=q.device) + int(kv_offset)
    allowed = span_allowed(rows, cols, spans)[:, None]
    s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    live = m > 0.5 * NEG_INF
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _launch(q, k, v, spans, softcap, q_offset, kv_offset, want_lse):
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel: dtype {q.dtype} (float32 or bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention kernel: {name} must match q's dtype and device")
        if t.shape != (b, h, nkv, d):
            raise ValueError(f"flash_attention kernel: {name} shape {tuple(t.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if spans is None:
        spans_t = torch.zeros((b, 0, 3), dtype=torch.int32, device=q.device)
    else:
        spans_t = spans.to(device=q.device, dtype=torch.int32).contiguous()
        if spans_t.shape[0] != b or spans_t.shape[2] != 3:
            raise ValueError(f"flash_attention kernel: spans shape {tuple(spans.shape)}")
    m = spans_t.shape[1]
    if m > MAX_SPANS:
        raise ValueError(f"flash_attention kernel: {m} spans > {MAX_SPANS}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.load("flash_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), spans_t.data_ptr(), m,
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, h, nq, nkv, d, int(q_offset), int(kv_offset),
        float(d**-0.5), float(softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, spans=None, causal=False, softcap=50.0,
                    q_offset=None, kv_offset=None, return_lse=False):
    """q [b,h,nq,d], k/v [b,h,nkv,d]; spans Int[b,m,3] | None. Causality is
    always on (as in the TPU kernels); `causal` only states that the caller
    wants it when no spans are given. q_offset/kv_offset (ints) are the
    global positions of q row 0 / kv column 0. return_lse=True also returns
    the per-row logsumexp Float32[b,h,nq]."""
    if spans is None and not causal:
        raise ValueError("flash_attention needs causal=True and/or spans")
    q_off = 0 if q_offset is None else int(q_offset)
    kv_off = 0 if kv_offset is None else int(kv_offset)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, spans, softcap, q_off, kv_off)
    elif q.device.type == "cuda":
        out, lse = _launch(q, k, v, spans, softcap, q_off, kv_off, return_lse)
    else:
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
