"""Core neural modules (counterpart of `transfusion_tpu/models/layers.py`).

Parameters carry the JAX package's names (`to_qk`, `to_v`,
`to_value_residual_mix`, `to_gates`, `to_out`, `proj_in`, `proj_out`,
`layernorm_gamma`, `layerscale`, `to_film`, `to_ada_ln_zero`, `gamma`) so
`weights.from_flax` maps one tree onto the other mechanically.

KV caches are preallocated buffers (`models/transformer.make_kv_cache`),
[b, h, cap, d] per layer. Attention writes the chunk's K/V into them IN
PLACE at the write index; the index and validity mask travel in the
returned cache dict. Scores and softmax are float32 whatever the compute
dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_tpu_torch.ops.decode_attn import decode_attention
from transfusion_tpu_torch.ops.flash_attn import flash_attention, supported
from transfusion_tpu_torch.ops.flash_attn_nhd import flash_attention_nhd, nhd_eligible
from transfusion_tpu_torch.ops.norms import l2norm, max_neg_value, safe_log, softclamp
from transfusion_tpu_torch.ops.rope import apply_rope
from transfusion_tpu_torch.ops.spans import span_allowed
from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.context import context_parallel_attention, ring_attention

CONTEXT_PARALLEL = ("ring", "cp_allgather")


# LASER's clamp of the values before exp (the JAX `laser_softclamp_value`)
LASER_SOFTCLAMP = 15.0


def random_fourier_embed(times, dim: int, weights):
    """[times, sin(2 pi f t), cos(2 pi f t)] with fixed frequencies
    `weights` Float[dim // 2]. times Float[b] or Float[b, n] ->
    Float32[b, n, dim + 1]."""
    if times.ndim == 1:
        times = times[:, None]
    times = times.to(torch.float32)
    freqs = times[..., None] * weights.to(torch.float32) * 2.0 * math.pi
    return torch.cat([times[..., None], torch.sin(freqs), torch.cos(freqs)], dim=-1)


def _quantize_rows(x, eps: float = 1e-8):
    """Symmetric absmax int8 quantization over the last axis:
    x -> (Int8[..., d], Float32[..., 1] scale), x ~= q * scale. Rows of
    zeros get scale eps. torch.round rounds half to even, as jnp.round."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=eps)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def apply_dropout(x, keep_mask, rate: float):
    """flax's `nn.Dropout` with the caller's keep mask Bool (x's shape):
    where(keep_mask, x / (1 - rate), 0) in x's dtype; zeros at rate 1; x
    itself without a mask or at rate 0 (flax's `deterministic=True`)."""
    if keep_mask is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if tuple(keep_mask.shape) != tuple(x.shape):
        raise ValueError(f"dropout mask {tuple(keep_mask.shape)} for a tensor {tuple(x.shape)}")
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))


def draw_keep_mask(shape, rate: float, generator, device):
    """A Bool keep mask of `shape`, True with probability 1 - rate (flax's
    `bernoulli(rng, 1 - rate, shape)`), drawn from `generator` on
    `device`."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


class RMSNorm(nn.Module):
    """l2norm(x) * sqrt(dim) * (gamma + 1), computed in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim**0.5
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        out = l2norm(x.float()) * self.scale * (self.gamma.float() + 1.0)
        return out.to(x.dtype)


class FeedForward(nn.Module):
    """GEGLU feedforward, inner width int(dim * expansion * 2 / 3), with
    dropout on the gated hidden layer ([b, n, inner]) when a keep mask is
    given.

    Tensor-parallel when handed tensor-local weights (`parallel/mesh.py`):
    proj_in keeps this rank's part of each half [h | gates] (column
    parallel), proj_out its rows (row parallel, its partial products summed
    over the axis `tp`, then the bias)."""

    tp = comm.SINGLE

    def __init__(self, dim: int, expansion_factor: float = 4.0, dropout: float = 0.0):
        super().__init__()
        self.dim_inner = int(dim * expansion_factor * 2 / 3)
        self.dropout = dropout
        self.proj_in = nn.Linear(dim, self.dim_inner * 2)
        self.proj_out = nn.Linear(self.dim_inner, dim)

    def forward(self, x, dropout_mask=None):
        il = self.proj_out.weight.shape[1]
        if il == self.dim_inner:
            h, gates = self.proj_in(x).chunk(2, dim=-1)
            h = apply_dropout(F.gelu(gates, approximate="none") * h, dropout_mask, self.dropout)
            return self.proj_out(h)
        if dropout_mask is not None:
            raise ValueError("dropout masks are not taken on tensor-local weights")
        lo, bias = self.tp.rank * il, self.proj_in.bias
        bias = torch.cat([bias[lo:lo + il], bias[self.dim_inner + lo:self.dim_inner + lo + il]])
        h, gates = F.linear(comm.copy_to(x, self.tp), self.proj_in.weight, bias).chunk(2, dim=-1)
        h = F.gelu(gates, approximate="none") * h
        return comm.reduce_from(F.linear(h, self.proj_out.weight), self.tp) + self.proj_out.bias


class Attention(nn.Module):
    """Multi-head attention: fused QK projection + separate V, learned
    value-residual mixing, per-head output gates, tanh softcap, interleaved
    RoPE, KV cache. forward returns (out, orig_values, new_cache).

    `dropout`: dropout on the float32 attention probabilities, with the
    caller's keep mask [b, h, n, kv], on the dense route of a call without
    a flash spec only (the JAX module's einsum path); the flash,
    token-major and decode routes, and the dense path that a flash spec
    takes for shapes the kernel does not take, apply none, as in the JAX
    package.

    `laser`: LASER attention, on every route: the attention reads the
    values as exp(softclamp(v, LASER_SOFTCLAMP)) and its output is
    taken back with safe_log; the value residual and the cache keep v
    itself. `fuse_projections`: to_qk, to_v, to_value_residual_mix and
    to_gates run as one product over their concatenated weights (the same
    parameters; the mix bias is added after it).

    Routes (as `transfusion_tpu.models.layers.Attention`):
      * uncached with a flash spec, inside `nhd_eligible(h, n, d)` (the
        training step at the bench shape) -> the token-major route:
        `flash_attention_nhd` on [b, n, h*d] with RoPE fused in the kernel;
        the value residual then travels in that layout too;
      * uncached with a flash spec otherwise -> RoPE in PyTorch, then
        `flash_attention` when `supported(n, d)`, else the dense path;
      * cached prefill with a flash spec -> `flash_attention` over the chunk
        alone (the cache is only written);
      * cached step with a decode bias -> `decode_attention` over the cache;
      * uncached with a flash spec and attn_impl 'ring' / 'cp_allgather'
        -> `parallel/context.py`'s schedule over `mesh`'s 'context' axis
        (the head-major route, as in JAX; a spec with neither spans nor
        causal is the modality-only path's full attention);
      * anything else -> the dense path against the cache (or the chunk).

    Tensor-parallel when handed tensor-local weights (`parallel/mesh.py`):
    to_qk / to_v / to_value_residual_mix keep this rank's heads, to_gates
    and the mix bias are sliced to them, and to_out's partial products are
    summed over the axis `tp`.
    """

    tp = comm.SINGLE

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 softcap_value: float = 50.0, gate_values: bool = True,
                 learned_value_residual_mix: bool = False, attn_impl: str = "dense",
                 laser: bool = False, fuse_projections: bool = False, dropout: float = 0.0,
                 mesh=None):
        super().__init__()
        self.mesh = mesh
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.dropout = dropout
        self.softcap_value = softcap_value
        self.attn_impl = attn_impl
        self.laser = laser
        self.fuse_projections = fuse_projections
        self.to_qk = nn.Linear(dim, inner * 2, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_value_residual_mix = (
            nn.Linear(dim, heads) if learned_value_residual_mix else None
        )
        self.to_gates = nn.Linear(dim, heads, bias=False) if gate_values else None
        self.to_out = nn.Linear(inner, dim, bias=False)

    def _split_heads(self, t):
        b, n, hd = t.shape
        return t.view(b, n, hd // self.dim_head, self.dim_head).transpose(1, 2)

    def _project(self, x):
        """(q, k, v, mix logits | None, gate logits | None), each [b, n, *],
        over this rank's heads."""
        h = self.to_v.weight.shape[0] // self.dim_head
        inner = h * self.dim_head
        mix, gates = self.to_value_residual_mix, self.to_gates
        mix_w = None if mix is None else mix.weight
        mix_b = None if mix is None else mix.bias
        gates_w = None if gates is None else gates.weight
        if h != self.heads:  # tensor-local heads: slice the replicated per-head rows
            x = comm.copy_to(x, self.tp)
            rows = slice(self.tp.rank * h, (self.tp.rank + 1) * h)
            mix_b = None if mix is None else mix_b[rows]
            gates_w = None if gates is None else gates_w[rows]
        if not self.fuse_projections:
            q, k = self.to_qk(x).chunk(2, dim=-1)
            return (q, k, self.to_v(x), None if mix is None else F.linear(x, mix_w, mix_b),
                    None if gates is None else F.linear(x, gates_w))
        ws = [w for w in (self.to_qk.weight, self.to_v.weight, mix_w, gates_w) if w is not None]
        y = F.linear(x, torch.cat(ws))
        q, k, v = y[..., :inner], y[..., inner:2 * inner], y[..., 2 * inner:3 * inner]
        off = 3 * inner
        mix_pre = gates_pre = None
        if mix is not None:
            mix_pre = y[..., off:off + h] + mix_b
            off += h
        if gates is not None:
            gates_pre = y[..., off:off + h]
        return q, k, v, mix_pre, gates_pre

    def _out(self, out):
        """to_out, its partial products summed over `tp` on tensor-local heads."""
        y = self.to_out(out)
        return y if out.shape[-1] == self.heads * self.dim_head else comm.reduce_from(y, self.tp)

    def _laser_values(self, v):
        return torch.exp(softclamp(v, LASER_SOFTCLAMP)) if self.laser else v

    def _forward_nhd(self, x, q, k, v, mix_pre, gates_pre, rope, value_residual, flash_spec):
        """The token-major route (JAX `layers.py:236-286`): q/k/v and the
        value residual stay [b, n, h*d]; per-head mix and gates are repeated
        over each head's d columns."""
        b, n, _ = x.shape
        d = self.dim_head
        orig_v = v
        if value_residual is not None:
            if mix_pre is not None:
                mix = torch.sigmoid(mix_pre).repeat_interleave(d, dim=-1)
            else:
                mix = 0.5
            v = v * mix + value_residual * (1.0 - mix)
        cos = sin = None
        if rope is not None:
            ang = (rope if rope.ndim > 2 else rope[None]).float().expand(b, n, d)
            cos, sin = torch.cos(ang), torch.sin(ang)
        out = flash_attention_nhd(
            q, k, self._laser_values(v), q.shape[-1] // d, cos=cos, sin=sin,
            spans=flash_spec.get("spans"), causal=flash_spec.get("causal", False),
            softcap=self.softcap_value,
        )
        if self.laser:
            out = safe_log(out)
        if gates_pre is not None:
            out = out * torch.sigmoid(gates_pre).repeat_interleave(d, dim=-1)
        return self._out(out), orig_v, None

    def route(self, n: int, flash_spec, cache, decode_bias, prefill: bool,
              heads: Optional[int] = None) -> str:
        """The route of a call on n query tokens over `heads` (default all)
        heads: 'nhd', 'decode', 'flash', 'cp' or 'dense' (see the class
        docstring)."""
        if flash_spec is not None and cache is None and self.attn_impl in CONTEXT_PARALLEL:
            return "cp"
        flash = flash_spec is not None and self.attn_impl == "flash"
        if flash and cache is None and decode_bias is None and nhd_eligible(
                heads or self.heads, n, self.dim_head):
            return "nhd"
        if cache is not None and decode_bias is not None and not prefill:
            return "decode"
        if flash and (cache is not None or supported(n, self.dim_head)):
            return "flash"
        return "dense"

    def forward(self, x, mask=None, rope=None, cache=None, value_residual=None,
                flash_spec=None, decode_bias=None, decode_lens=None, prefill=False,
                dropout_mask=None):
        b, n, _ = x.shape
        q, k, v, mix_pre, gates_pre = self._project(x)
        route = self.route(n, flash_spec, cache, decode_bias, prefill,
                           q.shape[-1] // self.dim_head)
        if route == "nhd":
            return self._forward_nhd(x, q, k, v, mix_pre, gates_pre, rope, value_residual,
                                     flash_spec)
        q, k, v = (self._split_heads(t) for t in (q, k, v))
        orig_v = v

        if value_residual is not None:
            if mix_pre is not None:
                mix = torch.sigmoid(mix_pre).transpose(1, 2)[..., None]
            else:
                mix = 0.5
            v = v * mix + value_residual * (1.0 - mix)

        if rope is not None:
            angles = rope if rope.ndim > 2 else rope[None]
            angles = angles[:, None]  # [b|1, 1, n, d]
            q = apply_rope(angles, q)
            k = apply_rope(angles, k)

        new_cache = None
        use_decode_kernel = route == "decode"
        if cache is not None:
            k_buf, v_buf, k_sc, v_sc = _write_cache(cache, k, v)
            new_cache = {**cache, "idx": cache["idx"] + n}
            if prefill and flash_spec is not None:
                k_full, v_full = k, v  # the chunk is the whole valid prefix
            elif use_decode_kernel:
                k_full = v_full = None  # the kernel reads the buffers
            elif k_sc is not None:
                k_full = (k_buf.float() * k_sc[..., None]).to(k.dtype)
                v_full = (v_buf.float() * v_sc[..., None]).to(v.dtype)
            else:
                k_full, v_full = k_buf, v_buf
        else:
            k_full, v_full = k, v

        if use_decode_kernel:
            out = decode_attention(
                q, k_buf, v_buf, decode_bias, k_scale=k_sc, v_scale=v_sc,
                softcap=self.softcap_value, lens=decode_lens,
            )
        elif route == "flash":
            out = flash_attention(
                q, k_full, self._laser_values(v_full), spans=flash_spec.get("spans"),
                causal=flash_spec.get("causal", False), softcap=self.softcap_value,
            )
        elif route == "cp":
            cp_fn = ring_attention if self.attn_impl == "ring" else context_parallel_attention
            out = cp_fn(q, k_full, self._laser_values(v_full), spans=flash_spec.get("spans"),
                        causal=flash_spec.get("causal", False), softcap=self.softcap_value,
                        mesh=self.mesh)
        else:
            if flash_spec is not None:
                # `transfusion_flash_attention`'s dense path for shapes the
                # kernel does not take: the mask comes from the spec
                seq = torch.arange(n, device=x.device)
                mask = span_allowed(seq, seq, flash_spec.get("spans"))[:, None]
            sim = torch.matmul(
                (q * self.dim_head**-0.5).float(), k_full.float().transpose(-1, -2)
            )
            if self.softcap_value > 0:
                sim = softclamp(sim, self.softcap_value)
            if mask is not None:
                sim = sim.masked_fill(~mask, max_neg_value(torch.float32))
            attn = torch.softmax(sim, dim=-1)
            if flash_spec is None:  # the flash function's dense path drops nothing
                attn = apply_dropout(attn, dropout_mask, self.dropout)
            v_att = self._laser_values(v_full)
            out = torch.matmul(attn.to(v_att.dtype).float(), v_att.float()).to(x.dtype)

        if self.laser:
            out = safe_log(out)
        if gates_pre is not None:
            out = out * torch.sigmoid(gates_pre).transpose(1, 2)[..., None]
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self._out(out), orig_v, new_cache


def _write_cache(cache, k, v):
    """Write the chunk's K/V ([b, h, n, d], post-RoPE) into the layer cache
    in place at cache['idx'] (a 0-d tensor, or Int[b] for per-row offsets).
    int8 caches quantize per (token, head) row. Returns the buffers and the
    scale buffers (None for float caches)."""
    b, h, n, d = k.shape
    k_buf, v_buf = cache["k"], cache["v"]
    pos = cache["idx"].reshape(-1, 1) + torch.arange(n, device=k.device)
    pos = pos.expand(b, n)
    index = pos[:, None, :, None].expand(b, h, n, d)
    k_sc = v_sc = None
    if k_buf.dtype == torch.int8:
        k_q, k_s = _quantize_rows(k)
        v_q, v_s = _quantize_rows(v)
        k_buf.scatter_(2, index, k_q)
        v_buf.scatter_(2, index, v_q)
        k_sc, v_sc = cache["k_scale"], cache["v_scale"]
        k_sc.scatter_(2, pos[:, None, :].expand(b, h, n), k_s[..., 0])
        v_sc.scatter_(2, pos[:, None, :].expand(b, h, n), v_s[..., 0])
    else:
        k_buf.scatter_(2, index, k.to(k_buf.dtype))
        v_buf.scatter_(2, index, v.to(v_buf.dtype))
    return k_buf, v_buf, k_sc, v_sc


class AdaptiveWrapper(nn.Module):
    """DiT-style per-token conditioning around a block.

    Text tokens: LayerNorm * (gamma + 1) in, * (layerscale + 1) out.
    Modality tokens: FiLM in, sigmoid ada-LN-zero gate out. Mixed sequences
    select per token via `is_any_modality`. The wrapped function is passed
    to `forward` (its parameters live beside this module's, as in the JAX
    tree); when it returns a tuple only the first element is conditioned.
    """

    def __init__(self, dim: int, dim_cond: int, ada_ln_zero_init_bias: float = -2.0):
        super().__init__()
        self.dim = dim
        self.layernorm_gamma = nn.Parameter(torch.zeros(dim))
        self.layerscale = nn.Parameter(torch.zeros(dim))
        self.to_film = nn.Linear(dim_cond, dim * 2)
        self.to_ada_ln_zero = nn.Linear(dim_cond, dim)
        nn.init.zeros_(self.to_film.weight)
        nn.init.zeros_(self.to_film.bias)
        nn.init.zeros_(self.to_ada_ln_zero.weight)
        nn.init.constant_(self.to_ada_ln_zero.bias, ada_ln_zero_init_bias)

    def forward(self, fn, x, cond=None, cond_index=None, is_any_modality=None, **kwargs):
        # the compute dtype is the wrapper's own (flax's `dtype=`): a float32
        # stream of a multi-stream bf16 model enters the branch in bf16
        dtype = self.layerscale.dtype
        x_ln = F.layer_norm(x.float(), (self.dim,), eps=1e-5).to(dtype)
        gamma_ln = self.layernorm_gamma.to(dtype)
        layerscale = self.layerscale.to(dtype)

        def run(fn_in):
            out = fn(fn_in, **kwargs)
            if isinstance(out, tuple):
                return out[0], out[1:]
            return out, None

        if cond is None:
            out, rest = run(x_ln * (gamma_ln + 1.0))
            out = out * (layerscale + 1.0)
        else:
            if cond.ndim == 2:
                cond = cond[:, None, :]
            film = self.to_film(cond)
            ada_gate = torch.sigmoid(self.to_ada_ln_zero(cond))
            if cond_index is not None:
                film = _gather_rows(film, cond_index)
                ada_gate = _gather_rows(ada_gate, cond_index)
            gamma_f, beta_f = film.to(dtype).chunk(2, dim=-1)
            ada_gate = ada_gate.to(dtype)
            if isinstance(is_any_modality, bool):
                is_any_modality = torch.full(
                    x.shape[:-1], is_any_modality, device=x.device
                )
            sel = is_any_modality[..., None]
            text_in = x_ln * (gamma_ln + 1.0)
            mod_in = x_ln * (gamma_f + 1.0) + beta_f
            out, rest = run(torch.where(sel, mod_in, text_in))
            out = torch.where(sel, out * ada_gate, out * (layerscale + 1.0))

        if rest is None:
            return out
        return (out, *rest)


def _gather_rows(t, index):
    """t [b, I, c], index Int[b, n] -> [b, n, c] (per-token cond rows)."""
    return torch.gather(t, 1, index[..., None].expand(-1, -1, t.shape[-1]))
