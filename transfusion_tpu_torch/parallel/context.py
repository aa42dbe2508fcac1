"""Context (sequence) parallelism: attention sharded over the sequence
(counterpart of `transfusion_tpu/parallel/context.py`).

The mesh's 'context' axis splits the packed sequence inside attention.
Global in, global out, as JAX's `shard_map` presents it: every rank of a
context group holds the whole [b, h, n, d] q / k / v (everything outside
attention is the same on each of them), takes its nl = n / P query rows
and its K/V chunk (`comm.slice_seq`), runs one of two schedules, and
all-gathers the output (`comm.gather_seq`). The transfusion mask is
evaluated at global (row, col) indices, so causality and modality
rectangles are exact across shards.

  * `context_parallel_attention`: K/V all-gathered over the group
    (`comm.gather_sum`); the local q slice against the whole K/V, through
    the flash kernel with q_offset = rank * nl;
  * `ring_attention`: the K/V chunks rotate around the group
    (`comm.ring_pass`) while (m, r, acc) accumulate locally; each chunk is
    one flash call with q_offset = rank * nl, kv_offset = src * nl and its
    lse, and the partials merge by the log-sum-exp combination
    (`ring_step`). Chunks that no row of the rank can see (`chunk_need`)
    launch nothing; they still travel on. Each chunk's backward is one
    call of the backward kernel at the merged output and lse
    (`_RingKernel`); dq, and each chunk's dk / dv on its way home, sum in
    float32.

Gradients are JAX's: the output's cotangent is the same on every rank of
the group and each takes its own rows; the backward of the slicing
all-gathers dq / dk / dv, so every rank of a group ends with the same
parameter gradients and no further reduction over 'context' is made.

With no structural mask (the modality-only forward), or a head dim or
length the kernel does not take (`_kernel_eligible`), a shard's work is
the dense online-softmax update (`_online_block_update`), as in JAX.

JAX's `_cp_specs` has no counterpart: the model hands attention its own
batch rows ('data', `parallel.mesh.batch_sharding`) and heads ('tensor',
tensor-local weights), so only 'context' is split here.

`ring_local` / `allgather_local` are one rank's schedule on chunks it
holds; `chip_smoke.py` runs them rank after rank in one process to hold
each rank's compute on the card. `ring_attention.chunks` counts the chunk
calls run and skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from transfusion_tpu_torch.ops.flash_attn import flash_attention, flash_attention_backward
from transfusion_tpu_torch.ops.norms import max_neg_value, softclamp
from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.mesh import axis_of

NEG_INF_RING = -1e30


def _global_allowed(batch, rows, cols, spans, causal):
    """The transfusion mask (causal | modality rectangles) at GLOBAL (row,
    col) indices; rows [nl, 1], cols [1, nc]. Returns Bool[b, nl, nc] or
    None (no structural mask)."""
    allowed = None
    if causal or spans is not None:
        allowed = (rows >= cols)[None].expand(batch, rows.shape[0], cols.shape[1])
    if spans is not None:
        offs, lens = spans[..., 1], spans[..., 2]  # [b, m]
        rect = ((rows[None, None] >= offs[:, :, None, None])
                & (cols[None, None] < (offs + lens)[:, :, None, None])).any(dim=1)
        allowed = allowed | rect
    return allowed


def _offset_attention(q, k, v, spans, causal, softcap, row_offset):
    """Dense attention where q rows are the global positions row_offset + i:
    q [b, h, nl, d], k / v [b, h, n, d]."""
    b, h, nl, d = q.shape
    n = k.shape[2]
    sim = torch.matmul((q * d**-0.5).float(), k.float().transpose(-1, -2))
    if softcap > 0:
        sim = softclamp(sim, softcap)
    rows = row_offset + torch.arange(nl, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    allowed = _global_allowed(b, rows, cols, spans, causal)
    if allowed is not None:
        sim = sim.masked_fill(~allowed[:, None], max_neg_value(torch.float32))
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype).float(), v.float()).to(q.dtype)


def _online_block_update(state, q, k_chunk, v_chunk, spans, causal, softcap, row_offset,
                         col_offset):
    """One online-softmax update of (m, l, acc) [b, h, nl, 1|1|d] against a
    KV chunk whose global columns start at col_offset."""
    m_prev, l_prev, acc = state
    b, h, nl, d = q.shape
    nc = k_chunk.shape[2]
    s = torch.matmul((q * d**-0.5).float(), k_chunk.float().transpose(-1, -2))
    if softcap > 0:
        s = softclamp(s, softcap)
    rows = row_offset + torch.arange(nl, device=q.device)[:, None]
    cols = col_offset + torch.arange(nc, device=q.device)[None, :]
    allowed = _global_allowed(b, rows, cols, spans, causal)
    if allowed is not None:
        s = s.masked_fill(~allowed[:, None], NEG_INF_RING)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(p, v_chunk.float())
    return m_new, l_new, acc_new


def _kernel_block_update(state, q, k_chunk, v_chunk, spans, causal, softcap, row_offset,
                         col_offset):
    """One flash call against a KV chunk (global offsets, lse returned), merged
    into (m, r, acc) [b, h, nl | nl | nl, d] by the log-sum-exp combination
    out = sum_i out_i e^{lse_i - m} / sum_i e^{lse_i - m}
    (JAX's `context.py:200-213`). A row that sees no column of the chunk
    has lse ~ -1e30 and output 0: it adds e^0 = 1 to r while m is still -1e30,
    and is rescaled away by the first chunk it does see."""
    m_prev, r, acc = state
    out_i, lse_i = flash_attention(q, k_chunk, v_chunk, spans, causal=causal, softcap=softcap,
                                   q_offset=row_offset, kv_offset=col_offset, return_lse=True)
    m_new = torch.maximum(m_prev, lse_i)
    alpha = torch.exp(m_prev - m_new)
    w = torch.exp(lse_i - m_new)
    acc = acc * alpha[..., None] + out_i.float() * w[..., None]
    return m_new, r * alpha + w, acc


def _kernel_eligible(nl, nkv, d, causal, spans):
    """A shard's work goes to the flash kernel (global q / kv offsets) when
    there is a structural mask (causal | spans), its head dim is one the
    kernels take and the shard and chunk lengths are multiples of 8 (the
    JAX package's envelope); else the dense update."""
    if not (causal or spans is not None):
        return False
    return d in (32, 64, 128, 256) and nl % 8 == 0 and nkv % 8 == 0


def _axis(mesh, axis: str, q) -> comm.Axis:
    """The context axis, once q's length is known to divide over it."""
    if mesh is None:
        raise ValueError("context-parallel attention needs a mesh with a "
                         f"'{axis}' axis (parallel.make_mesh(context=...))")
    ax = axis_of(mesh, axis)
    if q.shape[2] % ax.size:
        raise ValueError(f"sequence length {q.shape[2]} must be divisible by the context axis "
                         f"size {ax.size}: pick a pad_multiple divisible by it")
    return ax


def chunk_need(rank: int, size: int, nl: int, spans, causal: bool) -> list:
    """need[src]: whether any row of shard `rank` can see a column of shard
    `src` (JAX's `chunk_need`, `context.py:167-184`): src <= rank (the
    causal part, present whenever a structural mask is), or a span
    rectangle that spills into the chunk. Without a structural mask every
    chunk counts. One host read of the spans a call."""
    if not (causal or spans is not None):
        return [True] * size
    need = [src <= rank for src in range(size)]
    if spans is not None:
        sp = spans.detach().to("cpu").numpy()
        offs, lens = sp[..., 1], sp[..., 2]
        row_last = rank * nl + nl - 1
        for src in range(size):
            need[src] = need[src] or bool(np.any((lens > 0) & (row_last >= offs)
                                                 & (src * nl < offs + lens)))
    return need


def ring_init(q, use_kernel: bool):
    """(m, r | l, acc) before the first chunk."""
    b, h, nl, d = q.shape
    tail = () if use_kernel else (1,)
    return (torch.full((b, h, nl, *tail), NEG_INF_RING, dtype=torch.float32, device=q.device),
            torch.zeros((b, h, nl, *tail), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, nl, d), dtype=torch.float32, device=q.device))


def ring_step(state, q, k_chunk, v_chunk, spans, causal, softcap, row_offset, col_offset,
              use_kernel: bool):
    """One chunk of the ring: the flash call and its merge, or the dense
    online update."""
    update = _kernel_block_update if use_kernel else _online_block_update
    return update(state, q, k_chunk, v_chunk, spans, causal, softcap, row_offset, col_offset)


def ring_finish(state, dtype, use_kernel: bool):
    """The rank's output rows from the merged state."""
    _, r, acc = state
    return (acc / (r.clamp_min(1e-30)[..., None] if use_kernel else r.clamp_min(1e-30))).to(dtype)


class _RingKernel(torch.autograd.Function):
    """One rank's ring on the flash kernel. The backward is
    FlashAttention-2's ring backward: each chunk's backward call takes the
    merged output and lse (so p = exp(s - lse) is the whole row's softmax
    and delta = rowsum(do * out) that of the returned output, as in the
    whole-sequence call), and dq sums over the chunks in float32. The
    composition JAX differentiates instead (each chunk's own bf16 output
    and an lse cotangent through the merge) folds every chunk's output
    rounding into its delta: a row whose dq terms cancel then moves by up
    to ~0.8 of its RMS (PERF.md §6, the ring's backward)."""

    @staticmethod
    def forward(ctx, q_l, spans, meta, *chunks):
        rank, nl, srcs, causal, softcap = meta
        n = len(chunks) // 2
        state = ring_init(q_l, True)
        for k_c, v_c, src in zip(chunks[:n], chunks[n:], srcs):
            state = ring_step(state, q_l, k_c, v_c, spans, causal, softcap, rank * nl,
                              src * nl, True)
        out = ring_finish(state, q_l.dtype, True)
        lse = state[0] + torch.log(state[1].clamp_min(1e-30))  # the merged m + log r
        ctx.save_for_backward(q_l, out, lse, *chunks)
        ctx.spans, ctx.meta = spans, meta
        return out

    @staticmethod
    def backward(ctx, g):
        q_l, out, lse, *chunks = ctx.saved_tensors
        rank, nl, srcs, causal, softcap = ctx.meta
        n = len(chunks) // 2
        dq = torch.zeros(q_l.shape, dtype=torch.float32, device=q_l.device)
        dks, dvs = [], []
        for k_c, v_c, src in zip(chunks[:n], chunks[n:], srcs):
            dq_i, dk_i, dv_i = flash_attention_backward(
                q_l, k_c, v_c, out, lse, g, ctx.spans, softcap, rank * nl, src * nl,
                dq_float32=True)
            dq += dq_i
            dks.append(dk_i)
            dvs.append(dv_i)
        return (dq.to(q_l.dtype), None, None, *dks, *dvs)


def ring_local(q_l, k_chunks, v_chunks, rank: int, size: int, spans=None, causal=False,
               softcap: float = 50.0):
    """One rank's ring schedule: its nl query rows q_l against k_chunks[i] /
    v_chunks[i], the chunk it holds at step i (that of rank (rank - i) mod
    size). Chunks that `chunk_need` rules out launch nothing (and get no
    gradient)."""
    nl, d = q_l.shape[2], q_l.shape[3]
    use_kernel = _kernel_eligible(nl, nl, d, causal, spans)
    need = chunk_need(rank, size, nl, spans, causal)
    steps = [i for i in range(size) if need[(rank - i) % size]]
    ring_attention.chunks["run"] += len(steps)
    ring_attention.chunks["skipped"] += size - len(steps)
    if use_kernel:
        meta = (rank, nl, [(rank - i) % size for i in steps], causal, softcap)
        return _RingKernel.apply(q_l, spans, meta, *(k_chunks[i] for i in steps),
                                 *(v_chunks[i] for i in steps))
    state = ring_init(q_l, False)
    for i in steps:
        src = (rank - i) % size
        state = ring_step(state, q_l, k_chunks[i], v_chunks[i], spans, causal, softcap,
                          rank * nl, src * nl, False)
    return ring_finish(state, q_l.dtype, False)


def ring_attention(q, k, v, spans=None, causal=False, softcap: float = 50.0, mesh=None,
                   axis: str = "context"):
    """Ring-scheduled context-parallel transfusion attention. q / k / v:
    Float[b, h, n, d], the same on every rank of the context group (n
    divisible by its size); spans Int[b, m, 3] | None. Returns the whole
    output, the same on every rank."""
    ax = _axis(mesh, axis, q)
    q_l, k_l, v_l = comm.slice_seq((q, k, v), ax)
    k_cs, v_cs = comm.ring_pass(k_l, v_l, ax)
    out = ring_local(q_l, k_cs, v_cs, ax.rank, ax.size, spans, causal, softcap)
    return comm.gather_seq(out, ax)


ring_attention.chunks = {"run": 0, "skipped": 0}


def allgather_local(q_l, k_full, v_full, rank: int, spans=None, causal=False,
                    softcap: float = 50.0):
    """One rank's all-gather schedule: its nl query rows (global rows from
    rank * nl) against the whole K / V."""
    nl, d = q_l.shape[2], q_l.shape[3]
    if _kernel_eligible(nl, k_full.shape[2], d, causal, spans):
        return flash_attention(q_l, k_full, v_full, spans, causal=causal, softcap=softcap,
                               q_offset=rank * nl)
    return _offset_attention(q_l, k_full, v_full, spans, causal, softcap, rank * nl)


def context_parallel_attention(q, k, v, spans=None, causal=False, softcap: float = 50.0,
                               mesh=None, axis: str = "context"):
    """All-gather context-parallel transfusion attention; arguments and
    result as `ring_attention`."""
    ax = _axis(mesh, axis, q)
    q_l, k_l, v_l = comm.slice_seq((q, k, v), ax)
    k_full, v_full = comm.gather_sum((k_l, v_l), ax)
    return comm.gather_seq(allgather_local(q_l, k_full, v_full, ax.rank, spans, causal,
                                           softcap), ax)
