"""Cached decode attention — kernel 2 of the port.

Counterpart of `transfusion_tpu/ops/pallas_decode_kernel.py`
`decode_attention` (`_decode_kernel_dma`). The CUDA kernel is
`csrc/decode_attn.cu`; its source note says what bounds it on the H100 and
what the design does about it.

The port stores the cache as [b, h, cap, d] (the TPU's transposed
[b, h, d, cap] layout was a DMA alignment artifact), int8 scales as
[b, h, cap], and the validity bias as [b, cap] (no 8x sublane copy).

`decode_attention` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors. `decode_attention.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from transfusion_tpu_torch.ops import _build
from transfusion_tpu_torch.ops.norms import NEG_INF

HEAD_DIMS = (32, 64, 128)
MAX_QUERY_ROWS = 1024
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# decode_attn(q, k, v, k_scale, v_scale, bias, lens, out, b, h, nq, cap, d,
#             scale, softcap, kv_dtype, stream)
_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p]
)


def decode_supported(d: int, nq: int) -> bool:
    """Shapes the kernel takes: head dim 32/64/128, up to 1024 query rows.
    Any capacity works (the kernel masks the ragged last tile)."""
    return d in HEAD_DIMS and 1 <= nq <= MAX_QUERY_ROWS


def decode_attention_plain(q, k, v, bias, k_scale=None, v_scale=None,
                           softcap=50.0, lens=None):
    """Dense PyTorch version of the kernel's arithmetic; float32 output."""
    b, h, nq, d = q.shape
    cap = k.shape[2]
    qf = q.float() * d**-0.5
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = s + bias[:, None, None, :]
    if lens is not None:
        slot = torch.arange(cap, device=q.device)
        s = s.masked_fill((slot[None, :] >= lens[:, None])[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vf) / l
    return torch.where(m > 0.5 * NEG_INF, out, 0.0)


def _launch(q, k, v, bias, k_scale, v_scale, softcap, lens):
    b, h, nq, d = q.shape
    cap = k.shape[2]
    if not decode_supported(d, nq):
        raise ValueError(f"decode_attention kernel: head dim {d} / {nq} query rows")
    kv_dtype = _KV_DTYPES.get(k.dtype)
    if kv_dtype is None or v.dtype != k.dtype:
        raise TypeError(f"decode_attention kernel: cache dtype {k.dtype}/{v.dtype}")
    quant = kv_dtype == 2
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("decode_attention kernel: an int8 cache needs k_scale and v_scale")
    for name, t, shape in (
        ("k", k, (b, h, cap, d)), ("v", v, (b, h, cap, d)), ("bias", bias, (b, cap)),
        ("k_scale", k_scale, (b, h, cap)), ("v_scale", v_scale, (b, h, cap)),
    ):
        if t is None:
            continue
        if t.device != q.device:
            raise TypeError(f"decode_attention kernel: {name} on {t.device}, q on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_attention kernel: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel: {name} must be contiguous")
    if lens is None:
        lens = torch.full((b,), cap, dtype=torch.int32, device=q.device)
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    qf = q.float().contiguous()
    bias = bias.float()
    if quant:
        k_scale, v_scale = k_scale.float(), v_scale.float()
    out = torch.empty((b, h, nq, d), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attn", _ARGTYPES)
    err = fn(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        bias.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, h, nq, cap, d, float(d**-0.5), float(softcap), kv_dtype,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attn")
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, bias, k_scale=None, v_scale=None, softcap=50.0, lens=None):
    """q [b,h,nq,d] (nq <= 1024); k/v [b,h,cap,d] float32/bf16, or int8 with
    k_scale/v_scale Float32[b,h,cap]; bias Float32[b,cap] additive validity
    (0 | -1e30); lens Int[b] — row b streams slots [0, lens[b]) (None = the
    whole capacity). Returns [b,h,nq,d] in q's dtype."""
    if q.device.type == "cpu":
        out = decode_attention_plain(q, k, v, bias, k_scale, v_scale, softcap, lens)
    elif q.device.type == "cuda":
        out = _launch(q, k, v, bias, k_scale, v_scale, softcap, lens)
    else:
        raise RuntimeError(f"decode_attention: unsupported device {q.device}")
    return out.to(q.dtype)


decode_attention.launches = 0
