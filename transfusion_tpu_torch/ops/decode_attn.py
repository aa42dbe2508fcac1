"""Cached decode attention — kernel 2 of the port.

Counterpart of `transfusion_tpu/ops/pallas_decode_kernel.py`
`decode_attention` (`_decode_kernel_dma`). The CUDA kernel is
`csrc/decode_attn.cu`; its source note says what bounds it on the H100 and
what the design does about it.

The port stores the cache as [b, h, cap, d] (the TPU's transposed
[b, h, d, cap] layout was a DMA alignment artifact), int8 scales as
[b, h, cap], and the validity bias as [b, cap] (no 8x sublane copy).

`decode_attention` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors: the split kernel and, when the cache
is split in more than one chunk, the merge (`split_plan`). Nothing else is
launched: q and the output stay in q's dtype. `decode_attention.launches`
counts calls that launched the kernel, `decode_attention.kernels` the
kernels they enqueued (1 or 2 a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from transfusion_tpu_torch.ops import _build
from transfusion_tpu_torch.ops.flash_attn import _aligned
from transfusion_tpu_torch.ops.norms import NEG_INF

HEAD_DIMS = (32, 64, 128, 256)
MAX_QUERY_ROWS = 1024
WARP_ROWS = 16    # up to this many query rows: one row a block (text decode)
TILE_ROWS = 64    # above: 64-row query tiles (the ODE's modality rows)
SPLIT_SLOTS = 64  # a chunk of the cache is a multiple of this many slots
BLOCKS_PER_SM = 4
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# decode_attn(q, k, v, k_scale, v_scale, bias, lens, out, ws, b, h, nq, cap,
#             d, scale, softcap, kv_dtype, q_bf16, splits, chunk, strides, stream)
_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
)


def decode_supported(d: int, nq: int) -> bool:
    """Shapes the kernel takes: head dim 32/64/128/256, up to 1024 query
    rows. Any capacity works (the kernel masks the ragged last tile)."""
    return d in HEAD_DIMS and 1 <= nq <= MAX_QUERY_ROWS


def split_plan(b: int, h: int, nq: int, cap: int, sm_count: int) -> tuple[int, int]:
    """(splits, chunk): the kernel cuts every row's cache into `splits`
    chunks of `chunk` slots (a multiple of 64; the last one ragged), one
    block per (b*h, query tile, chunk). The fewest splits that give the card
    BLOCKS_PER_SM blocks an SM, as far as the capacity's 64-slot tiles
    allow. Planned from the shapes alone: reading `lens` back would
    synchronise every layer of every decode step, so chunks past a row's
    length are launched and exit at once."""
    tiles = -(-cap // SPLIT_SLOTS)
    q_tiles = nq if nq <= WARP_ROWS else -(-nq // TILE_ROWS)
    want = min(tiles, -(-BLOCKS_PER_SM * sm_count // (b * h * q_tiles)))
    per = tiles // max(want, 1)  # 64-slot tiles a chunk
    return -(-tiles // per), SPLIT_SLOTS * per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def merge_partials(m, l, acc):
    """The merge kernel's arithmetic: per-chunk partials of one query row
    (m, l float32 [splits, ...]; acc [splits, ..., d], unnormalised) to the
    output: sum_s acc_s e^{m_s - M} / sum_s l_s e^{m_s - M}, M = max_s m_s,
    skipping chunks with no valid slot (m_s = -1e30), and 0 where every
    chunk had none."""
    big = m.amax(0)
    seen = m > 0.5 * NEG_INF
    w = torch.where(seen, torch.exp(m - big), 0.0)
    num = torch.where(seen[..., None], acc, 0.0).mul(w[..., None]).sum(0)
    out = num / (l * w).sum(0).clamp_min(1e-30)[..., None]
    return torch.where((big > 0.5 * NEG_INF)[..., None], out, 0.0)


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
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention kernel: q dtype {q.dtype} (float32 or bfloat16)")
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
    if lens is not None:
        lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    # q as it comes (the model's [b, h, nq, d] view of its token-major
    # projection), unless its rows are not contiguous and 16-byte aligned
    if q.stride(-1) != 1 or any(x * q.element_size() % 16 for x in q.stride()[:3]):
        q = q.contiguous()
    q = _aligned(q)
    k, v = (_aligned(t) for t in (k, v))
    bias = bias.float()
    if quant:
        k_scale, v_scale = k_scale.float(), v_scale.float()
    splits, chunk = split_plan(b, h, nq, cap, _sm_count(q.device.index))
    out = torch.empty_like(q)  # q's layout, so the caller's transpose back is free
    ws = None
    if splits > 1:  # the chunks' partials: acc [splits, b*h*nq, d], (m, l)
        ws = torch.empty(splits * b * h * nq * (d + 2), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attn", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        bias.data_ptr(), None if lens is None else lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        b, h, nq, cap, d, float(d**-0.5), float(softcap), kv_dtype,
        int(q.dtype == torch.bfloat16), splits, chunk,
        (ctypes.c_longlong * 6)(*q.stride()[:3], *out.stride()[:3]),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attn")
    decode_attention.launches += 1
    decode_attention.kernels += 1 + (splits > 1)  # the split kernel, then the merge
    return out


def decode_attention(q, k, v, bias, k_scale=None, v_scale=None, softcap=50.0, lens=None):
    """q [b,h,nq,d] (nq <= 1024); k/v [b,h,cap,d] float32/bf16, or int8 with
    k_scale/v_scale Float32[b,h,cap]; bias Float32[b,cap] additive validity
    (0 | -1e30); lens Int[b] — row b streams slots [0, lens[b]) (None = the
    whole capacity). Returns [b,h,nq,d] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, k_scale, v_scale, softcap, lens).to(q.dtype)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, k_scale, v_scale, softcap, lens)
    raise RuntimeError(f"decode_attention: unsupported device {q.device}")


decode_attention.launches = 0
decode_attention.kernels = 0
