"""Flash attention with the transfusion mask, head-major — kernel 1 (forward)
and the backward kernel of the port.

Counterpart of `transfusion_tpu/ops/pallas_attn_kernel.py` `flash_attention`:
the forward `_flash_fwd` -> `_kernel_batched_heads` / `_kernel` /
`_kernel_streamed` is `csrc/flash_fwd.cu`; the backward of its custom VJP
(`_bwd` -> `_bwd_kernel_batched_heads` or `_bwd_dkv_kernel` +
`_bwd_dq_kernel`) is `csrc/flash_bwd.cu`. Their source notes say what
bounds them on the H100 and what the design does about it. The token-major
route (`flash_attention_nhd`) shares both kernels; it lives in
`ops/flash_attn_nhd.py`.

`flash_attention` is a `torch.autograd.Function` when a gradient is asked
for (and a plain call otherwise, as on the serving path). Each wrapper
takes the plain PyTorch version for CPU tensors and launches the kernel for
CUDA tensors (there is no fallback between the two).
`flash_attention.launches` and `flash_attention_backward.launches` count
kernel launches; their `launches_by_row` dicts count the same launches by
the TPU kernel that the JAX route would have run for the shape (`tpu_row`:
rows 1-3 of the kernel table for the forward, 7-9 for the backward).

Mask contract (global coordinates i = q_offset + row, j = kv_offset + col):

    allowed(i, j) = i >= j | any_m[len_m > 0 & i >= off_m & j < off_m + len_m]

with a tanh softcap on the logits after the d^-1/2 scale. A row that sees
no column returns 0 and logsumexp ~ -1e30, and gets zero gradients.
"""

from __future__ import annotations

import ctypes

import torch

from transfusion_tpu_torch.ops import _build
from transfusion_tpu_torch.ops.norms import NEG_INF
from transfusion_tpu_torch.ops.spans import span_allowed

HEAD_DIMS = (32, 64, 128, 256)
# (q k width, value width) pairs the kernels take beside the equal widths of
# HEAD_DIMS, head-major only: (192, 128) is DeepSeek-V3-style latent
# attention (128 dims without RoPE and 64 with it beside 128-dim values)
HEAD_DIM_PAIRS = ((192, 128),)
# The JAX route's envelopes (pallas_attn_kernel.py:1178-1214). The TPU picks
# its kernel by what fits in VMEM; the CUDA kernels stream tiles from device
# memory and take every shape up to the overall cap, so here the envelopes
# only name the TPU kernel a call stands in for (`tpu_row`).
_MAX_HND_BATCHED = 8 * 256 * 64
_MAX_SCORE_ELEMS_FWD = 256 * 1024
_MAX_SCORE_ELEMS_BWD = 128 * 1024
_MAX_N_TIMES_D_RESIDENT = 4096 * 64
_MAX_N_TIMES_D_BWD = 8192 * 64
_MAX_N_TIMES_D = 131072 * 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash_fwd(q, k, v, spans, m, cos, sin, out, lse, b, h, nq, nkv, d, d_v,
#           q_off, kv_off, nhd, scale, softcap, is_bf16, stream)
_FWD_ARGTYPES = [_P] * 4 + [_I] + [_P] * 4 + [_I] * 9 + [_F] * 2 + [_I, _P]
# flash_bwd(q, k, v, dout, lse, delta, cancel, spans, m, cos, sin, dq, dk, dv,
#           dq_acc, ends, b, h, nq, nkv, d, d_v, q_off, kv_off, nhd, scale,
#           softcap, is_bf16, stream)
_BWD_ARGTYPES = [_P] * 8 + [_I] + [_P] * 7 + [_I] * 9 + [_F] * 2 + [_I, _P]


def widths_supported(d: int, dv: int) -> bool:
    """The kernels take q k width d beside value width dv (head-major)."""
    return (d == dv and d in HEAD_DIMS) or (d, dv) in HEAD_DIM_PAIRS


def supported(n: int, d: int, dv: int | None = None) -> bool:
    """`transfusion_flash_attention` takes the kernel for these shapes and
    the dense path otherwise (pallas_attn_kernel.py:1224); dv: the value
    width when it differs from the q k width d."""
    return n * d <= _MAX_N_TIMES_D and widths_supported(d, d if dv is None else dv)


def _use_batched(h: int, nq: int, nkv: int, d: int, *, bwd: bool) -> bool:
    """The JAX batched-heads envelope (`_use_batched`, pallas_attn_kernel.py:1193)."""
    if h * max(nq, nkv) * d > _MAX_HND_BATCHED:
        return False
    return nq * nkv <= (_MAX_SCORE_ELEMS_BWD if bwd else _MAX_SCORE_ELEMS_FWD)


def tpu_row(h: int, nq: int, nkv: int, d: int, *, bwd: bool) -> int:
    """The kernel-table row of the TPU kernel that the JAX route runs at
    these lengths: `_flash_fwd` (:359-360) takes row 3 (`_kernel_streamed`)
    above 4096·64, else row 1 (`_kernel_batched_heads`) inside the batched
    envelope, else row 2 (`_kernel`); `_bwd` (:1084-1100) takes row 7
    (`_bwd_kernel_batched_heads`), row 9 (`_flash_bwd_streamed`) above
    8192·64, else row 8 (`_flash_bwd`). The lengths are the call's own (the
    JAX wrapper first pads a call without offsets to a multiple of 128)."""
    long = max(nq, nkv) * d
    if not bwd:
        if long > _MAX_N_TIMES_D_RESIDENT:
            return 3
        return 1 if _use_batched(h, nq, nkv, d, bwd=False) else 2
    if _use_batched(h, nq, nkv, d, bwd=True) and long <= _MAX_N_TIMES_D_BWD:
        return 7
    return 9 if long > _MAX_N_TIMES_D_BWD else 8


def flash_attention_plain(q, k, v, spans=None, softcap=50.0, q_offset=0, kv_offset=0,
                          block_q=None):
    """Dense PyTorch version of the forward kernel's arithmetic; v's width
    may differ from q's and k's. Returns (out [b,h,nq,dv] in q's dtype, lse
    float32 [b,h,nq]). block_q: compute
    block_q query rows at a time (the same arithmetic; the score matrix of
    a long sequence does not fit in memory whole)."""
    if block_q is not None and block_q < q.shape[2]:
        parts = [flash_attention_plain(q[:, :, i:i + block_q], k, v, spans, softcap,
                                       int(q_offset) + i, kv_offset)
                 for i in range(0, q.shape[2], block_q)]
        return torch.cat([o for o, _ in parts], 2), torch.cat([l for _, l in parts], 2)
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


def backward_plain_f32(q, k, v, do, lse, delta, spans=None, softcap=50.0, q_offset=0,
                       kv_offset=0, block_q=None, round_operands=None):
    """The backward kernels' arithmetic, written out (not autograd through
    the forward), in float32, at any value width (dv, like v's, may differ
    from dq's and dk's): p recomputed from lse under `where(allowed)`,
    ds = p (dp - delta) (1 - (s/cap)^2), q scaled in float32 and dq scaled
    again. Returns float32 (dq, dk, dv). block_q: block_q query rows at a
    time, dk and dv summed over the blocks in float32. round_operands (a
    dtype, e.g. torch.bfloat16): the bf16 kernel's rounding instead, for
    measuring its error budget: p as a pair hi + lo of that dtype in the dv
    product, ds rounded to it before the dk/dq products, q unscaled in the
    products and the scale applied to the float32 results."""
    if block_q is not None and block_q < q.shape[2]:
        dqs, dk, dv = [], 0.0, 0.0
        for i in range(0, q.shape[2], block_q):
            rows = slice(i, i + block_q)
            dq_i, dk_i, dv_i = backward_plain_f32(
                q[:, :, rows], k, v, do[:, :, rows], lse[:, :, rows], delta[:, :, rows],
                spans, softcap, int(q_offset) + i, kv_offset, round_operands=round_operands)
            dqs.append(dq_i)
            dk, dv = dk + dk_i, dv + dv_i
        return torch.cat(dqs, 2), dk, dv
    nq, d = q.shape[2], q.shape[3]
    nkv = k.shape[2]
    scale = d**-0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    if round_operands is None:
        qf = qf * scale
        s = torch.matmul(qf, kf.transpose(-1, -2))
    else:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    chain = 1.0
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
        chain = 1.0 - (s / softcap) ** 2
    rows = torch.arange(nq, device=q.device) + int(q_offset)
    cols = torch.arange(nkv, device=q.device) + int(kv_offset)
    allowed = span_allowed(rows, cols, spans)[:, None]
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * chain
    if round_operands is not None:
        hi = p.to(round_operands).float()
        p = hi + (p - hi).to(round_operands).float()
        ds = ds.to(round_operands).float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf) * scale
    if round_operands is not None:
        dk = dk * scale
    return dq, dk, dv


def flash_attention_backward_plain(q, k, v, do, lse, delta, spans=None, softcap=50.0,
                                   q_offset=0, kv_offset=0, block_q=None):
    """Plain version of the backward kernel: (dq, dk, dv) in the inputs'
    dtypes. delta = rowsum(dO * O) - g_lse, float32 [b,h,nq]."""
    dq, dk, dv = backward_plain_f32(q, k, v, do, lse, delta, spans, softcap, q_offset,
                                    kv_offset, block_q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel launches (shared with the token-major route)
# ---------------------------------------------------------------------------


def _check(what, q, k, v, b, h, nq, nkv, d, q_off, kv_off, rest=(), d_v=None):
    """Refuse what the kernels cannot take (d_v: the value width, d unless
    given). They index device memory with 64-bit offsets (any element
    count, any b * h, any span count), but take lengths and global
    positions as 32-bit ints."""
    d_v = d if d_v is None else d_v
    if not widths_supported(d, d_v):
        raise ValueError(f"{what} kernel: head dims (q k {d}, v {d_v}): equal and in "
                         f"{HEAD_DIMS}, or one of {HEAD_DIM_PAIRS}")
    if min(q_off, kv_off) < -(2**31) or max(q_off + nq, kv_off + nkv) > 2**31:
        raise ValueError(f"{what} kernel: positions [{q_off}, {q_off + nq}) / "
                         f"[{kv_off}, {kv_off + nkv}) do not fit in int32")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel: dtype {q.dtype} (float32 or bfloat16)")
    for name, t in (("k", k), ("v", v), *rest):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{what} kernel: {name} must match q's dtype and device")


def _spans_arg(what, spans, b, device):
    if spans is None:
        return torch.zeros((b, 0, 3), dtype=torch.int32, device=device)
    spans_t = spans.to(device=device, dtype=torch.int32).contiguous()
    if spans_t.ndim != 3 or spans_t.shape[0] != b or spans_t.shape[2] != 3:
        raise ValueError(f"{what} kernel: spans shape {tuple(spans.shape)}")
    return spans_t


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the bf16
    kernels read rows, and RoPE angles, as 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rope_args(cos, sin, b, n, d, device):
    if cos is None:
        return None, None, 0, 0
    cos = _aligned(cos.to(device=device, dtype=torch.float32).expand(b, n, d).contiguous())
    sin = _aligned(sin.to(device=device, dtype=torch.float32).expand(b, n, d).contiguous())
    return cos, sin, cos.data_ptr(), sin.data_ptr()


def launch_fwd(q, k, v, spans, softcap, q_offset, kv_offset, want_lse, *, heads=None,
               cos=None, sin=None):
    """Launch csrc/flash_fwd.cu: for bf16 the tensor-core kernel, for
    float32 the FMA kernel. heads=None: head-major q [b,h,nq,d], k
    [b,h,nkv,d], v [b,h,nkv,dv] (dv = d, or a pair of HEAD_DIM_PAIRS);
    heads=h: token-major [b,n,h*d] with optional RoPE angles cos/sin
    [b,n,d]. Returns (out [.., dv] like v's width in q's layout, lse
    float32 [b,h,nq] | None). Callers count the launch."""
    nhd = heads is not None
    if nhd:
        b, nq, hd = q.shape
        h, d, nkv = heads, hd // heads, k.shape[1]
        d_v = d
        shape_k = shape_v = (b, nkv, hd)
    else:
        b, h, nq, d = q.shape
        nkv, d_v = k.shape[2], v.shape[-1]
        shape_k, shape_v = (b, h, nkv, d), (b, h, nkv, d_v)
    what = "flash_attention_nhd" if nhd else "flash_attention"
    _check(what, q, k, v, b, h, nq, nkv, d, int(q_offset), int(kv_offset), d_v=d_v)
    for name, t, shape in (("k", k, shape_k), ("v", v, shape_v)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} kernel: {name} shape {tuple(t.shape)}")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    spans_t = _spans_arg(what, spans, b, q.device)
    cos, sin, cos_p, sin_p = _rope_args(cos, sin, b, nq, d, q.device)
    out = torch.empty_like(q) if d_v == d else q.new_empty((b, h, nq, d_v))
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.load("flash_fwd", _FWD_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), spans_t.data_ptr(), spans_t.shape[1],
        cos_p, sin_p, out.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, h, nq, nkv, d, d_v, int(q_offset), int(kv_offset), int(nhd),
        float(d**-0.5), float(softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd")
    return out, lse


def launch_bwd(q, k, v, do, lse, delta, spans, softcap, q_offset, kv_offset, *, heads=None,
               cos=None, sin=None, dq_float32=False):
    """Launch csrc/flash_bwd.cu in either layout (see `launch_fwd`): the
    kernel that writes each q row's visible end into a scratch, then for
    bf16 the two that bound each row's cancellation (the heads' largest |v|,
    then the bound, into a second scratch), the tensor-core dK/dV kernel,
    which adds dq into a zeroed float32 scratch, and the kernel that stores
    dq from it; for float32 the dK/dV and dQ kernels. Returns (dq, dk, dv) like q, k, v; with dq_float32
    (head-major only) dq is the float32 scratch times the scale, before the
    store rounds it. Callers count the launch."""
    nhd = heads is not None
    if nhd:
        b, nq, hd = q.shape
        h, d, nkv = heads, hd // heads, k.shape[1]
        d_v = d
    else:
        b, h, nq, d = q.shape
        nkv, d_v = k.shape[2], v.shape[-1]
    what = "flash_attention_nhd backward" if nhd else "flash_attention backward"
    _check(what, q, k, v, b, h, nq, nkv, d, int(q_offset), int(kv_offset),
           rest=(("dout", do),), d_v=d_v)
    q, k, v, do = (_aligned(t.contiguous()) for t in (q, k, v, do))
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    if tuple(lse.shape) != (b, h, nq) or tuple(delta.shape) != (b, h, nq):
        raise ValueError(f"{what} kernel: lse/delta must be [b, h, nq] = {(b, h, nq)}")
    spans_t = _spans_arg(what, spans, b, q.device)
    cos, sin, cos_p, sin_p = _rope_args(cos, sin, b, nq, d, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = cancel = None
    if q.dtype == torch.bfloat16:
        dq_acc = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
        cancel = torch.empty(b * h * (2 * nq + 1), dtype=torch.float32, device=q.device)
    ends = torch.empty((b, nq), dtype=torch.int32, device=q.device)  # each q row's visible end
    fn = _build.load("flash_bwd", _BWD_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if cancel is None else cancel.data_ptr(), spans_t.data_ptr(),
        spans_t.shape[1], cos_p, sin_p,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if dq_acc is None else dq_acc.data_ptr(), ends.data_ptr(),
        b, h, nq, nkv, d, d_v, int(q_offset), int(kv_offset), int(nhd),
        float(d**-0.5), float(softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_bwd")
    if dq_float32:
        if nhd:
            raise ValueError("dq_float32 is taken on the head-major layout only")
        dq = dq.float() if dq_acc is None else dq_acc * float(d**-0.5)
    return dq, dk, dv


def _device_kind(what, t):
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# head-major entry points
# ---------------------------------------------------------------------------


def _forward(q, k, v, spans, softcap, q_off, kv_off, want_lse):
    if _device_kind("flash_attention", q) == "cpu":
        return flash_attention_plain(q, k, v, spans, softcap, q_off, kv_off)
    out = launch_fwd(q, k, v, spans, softcap, q_off, kv_off, want_lse)
    flash_attention.launches += 1
    b, h, nq, d = q.shape
    flash_attention.launches_by_row[tpu_row(h, nq, k.shape[2], d, bwd=False)] += 1
    return out


def flash_attention_backward(q, k, v, o, lse, do, spans=None, softcap=50.0, q_offset=0,
                             kv_offset=0, g_lse=None, dq_float32=False):
    """Gradients (dq, dk, dv) of `flash_attention` at output o and its lse,
    for the output cotangent do and, with return_lse, the lse cotangent
    g_lse [b,h,nq] (folded into delta = rowsum(do * o) - g_lse). With
    dq_float32, dq comes in float32, not rounded to q's dtype (a caller that
    sums dq over several calls, as ring attention's chunks, sums it so)."""
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    args = (q, k, v, do, lse, delta, spans, softcap, int(q_offset), int(kv_offset))
    if _device_kind("flash_attention backward", q) == "cpu":
        dq, dk, dv = backward_plain_f32(*args)
        return (dq if dq_float32 else dq.to(q.dtype)), dk.to(k.dtype), dv.to(v.dtype)
    out = launch_bwd(*args, dq_float32=dq_float32)
    flash_attention_backward.launches += 1
    b, h, nq, d = q.shape
    flash_attention_backward.launches_by_row[tpu_row(h, nq, k.shape[2], d, bwd=True)] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, spans, softcap, q_off, kv_off, return_lse):
        out, lse = _forward(q, k, v, spans, softcap, q_off, kv_off, True)
        ctx.save_for_backward(q, k, v, out, lse, spans)
        ctx.cfg = (softcap, q_off, kv_off, return_lse)
        return (out, lse) if return_lse else out

    @staticmethod
    def backward(ctx, g, g_lse=None):
        q, k, v, out, lse, spans = ctx.saved_tensors
        softcap, q_off, kv_off, return_lse = ctx.cfg
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, g, spans, softcap, q_off, kv_off,
            g_lse if return_lse else None,
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, spans=None, causal=False, softcap=50.0,
                    q_offset=None, kv_offset=None, return_lse=False):
    """q [b,h,nq,d], k [b,h,nkv,d], v [b,h,nkv,dv] (dv = d, or a pair of
    HEAD_DIM_PAIRS on the card; any on the CPU); spans Int[b,m,3] | None;
    softcap 0 is none. Causality is
    always on (as in the TPU kernels); `causal` only states that the caller
    wants it when no spans are given. q_offset/kv_offset (ints) are the
    global positions of q row 0 / kv column 0. return_lse=True also returns
    the per-row logsumexp Float32[b,h,nq]. Differentiable in q, k, v (and
    through the lse when it is returned)."""
    if spans is None and not causal:
        raise ValueError("flash_attention needs causal=True and/or spans")
    q_off = 0 if q_offset is None else int(q_offset)
    kv_off = 0 if kv_offset is None else int(kv_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, spans, softcap, q_off, kv_off, return_lse)
    out, lse = _forward(q, k, v, spans, softcap, q_off, kv_off, return_lse)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_row = {1: 0, 2: 0, 3: 0}
flash_attention_backward.launches = 0
flash_attention_backward.launches_by_row = {7: 0, 8: 0, 9: 0}
