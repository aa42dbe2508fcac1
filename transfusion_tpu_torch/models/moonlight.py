"""The DeepSeek-V3 block of Moonlight-16B-A3B (`model_type` deepseek_v3) in
the port: multi-head latent attention (MLA), a SwiGLU feed-forward and a
DeepSeekMoE expert layer, stacked by `MoonlightTransformer`, which a
transformer config with "block": "moonlight" builds, its shapes under
"moonlight" in the published config.json's keys.

Each layer is pre-norm, h = x + MLA(RMSNorm(x)), y = h + FFN(RMSNorm(h)):

  * MLA (no q LoRA): q = W_q x, heads x (qk_nope_head_dim + qk_rope_head_dim);
    [c | k_rope] = W_kva x, kv_lora_rank + qk_rope_head_dim; c is RMS-normed
    with its own weight and eps 1e-6 (the modeling code builds that norm
    without the config's eps); [k_nope | v] = W_kvb c, heads x
    (qk_nope_head_dim + v_head_dim). RoPE acts on q's last qk_rope_head_dim
    columns and on the one k_rope every head shares (the interleaved pairs
    here, the modeling code's de-interleaved halves: the same scores).
    Scores q.k / sqrt(q k width), no softcap; the head-major flash kernels
    take q k 192 beside v 128 (`ops/flash_attn.py`).
  * The feed-forward of layers below first_k_dense_replace is a SwiGLU of
    intermediate_size; the others are `MoE`: a sigmoid router in float32
    over n_routed_experts, each token's num_experts_per_tok experts chosen
    by score + a selection bias (a buffer: no gradient, no optimizer),
    weighted by their scores normalised to sum 1 and times
    routed_scaling_factor; n_shared_experts shared experts as one SwiGLU.

A layer holds `experts_held` of the routed experts (the first ones: rank
0's share under expert parallelism). It routes over all of them and adds
the part of the output its own experts give, plus the shared experts: the
sum of every rank's part with the shared experts once is the whole layer.
On the card the held experts' products are grouped GEMMs over the
assignments sorted by expert, the group offsets on the device (no host
sync); the assignments of other ranks' experts sort past the last group
and are never multiplied. Dispatch and combine are gathers (deterministic:
a recomputed forward under remat routes exactly as the first). On the CPU
a loop over the experts computes the same.

The stack has no adaptive wrappers, U-Net skips, value residual or
hyper-connections; RoPE covers the q k rope dims. Time enters once, at the
input: the time embedding (`to_time_cond`) through one `time_in` Linear(4
dim -> dim) is added to each modality token's input vector (the Transfusion
paper's conditioning of its linear patch encoder, arXiv 2408.11039 section
3.2). It runs uncached calls only (a latent KV cache is not in the port),
no dropout and no pipeline stages.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transfusion_tpu_torch.models.layers import CONTEXT_PARALLEL
from transfusion_tpu_torch.models.transformer import Transformer
from transfusion_tpu_torch.ops.flash_attn import flash_attention, supported
from transfusion_tpu_torch.ops.norms import NEG_INF
from transfusion_tpu_torch.ops.rope import apply_rope
from transfusion_tpu_torch.ops.spans import span_allowed
from transfusion_tpu_torch.training.metrics import span

# what `MoonlightTransformer(moonlight=...)` takes (config.json's names) and
# `experts_held`, the routed experts this layer holds
KEYS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "intermediate_size", "moe_intermediate_size", "n_routed_experts", "experts_held",
        "num_experts_per_tok", "n_shared_experts", "routed_scaling_factor",
        "first_k_dense_replace", "rms_norm_eps")
LATENT_NORM_EPS = 1e-6  # the modeling code's default: its latent norm takes no eps


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) in float32, cast back, times a learned
    weight (initialised to 1)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * y.to(x.dtype)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.gate_proj = nn.Linear(dim, inner, bias=False)
        self.up_proj = nn.Linear(dim, inner, bias=False)
        self.down_proj = nn.Linear(inner, dim, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLAttention(nn.Module):
    """Multi-head latent attention, uncached (training and the joint
    forward). forward(x, rope [b|1, n, qk_rope_head_dim] angles, flash_spec
    | None, mask | None) -> [b, n, dim]."""

    def __init__(self, dim: int, heads: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, attn_impl: str, eps: float):
        super().__init__()
        self.heads, self.attn_impl = heads, attn_impl
        self.nope, self.rope_dim, self.v_dim = qk_nope_head_dim, qk_rope_head_dim, v_head_dim
        self.qk_dim = qk_nope_head_dim + qk_rope_head_dim
        self.kv_lora_rank = kv_lora_rank
        self.q_proj = nn.Linear(dim, heads * self.qk_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(dim, kv_lora_rank + qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(kv_lora_rank, LATENT_NORM_EPS)
        self.kv_b_proj = nn.Linear(kv_lora_rank, heads * (qk_nope_head_dim + v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(heads * v_head_dim, dim, bias=False)

    def qkv(self, x, rope):
        """q, k [b, h, n, qk_dim] and v [b, h, n, v_dim]: the latent
        projections and the assembly of the heads."""
        b, n, _ = x.shape
        h = self.heads
        q = self.q_proj(x).view(b, n, h, self.qk_dim).transpose(1, 2)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.kv_lora_rank, self.rope_dim], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, n, h, self.nope + self.v_dim)
        k_nope, v = kv.transpose(1, 2).split([self.nope, self.v_dim], -1)
        q_nope, q_pe = q.split([self.nope, self.rope_dim], -1)
        angles = (rope if rope.ndim > 2 else rope[None])[:, None]
        q_pe = apply_rope(angles, q_pe)
        k_pe = apply_rope(angles, k_pe[:, None]).expand(b, h, n, self.rope_dim)
        return torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1), v

    def forward(self, x, rope, flash_spec=None, mask=None):
        b, n, _ = x.shape
        with span("transfusion.attn.mla"):
            q, k, v = self.qkv(x, rope)
        if (flash_spec is not None and self.attn_impl == "flash"
                and supported(n, self.qk_dim, self.v_dim)):
            out = flash_attention(q, k, v, spans=flash_spec.get("spans"),
                                  causal=flash_spec.get("causal", False), softcap=0.0)
        else:
            if flash_spec is not None:
                seq = torch.arange(n, device=x.device)
                mask = span_allowed(seq, seq, flash_spec.get("spans"))[:, None]
            sim = torch.matmul(q.float() * self.qk_dim**-0.5, k.float().transpose(-1, -2))
            if mask is not None:
                sim = sim.masked_fill(~mask, NEG_INF)
            out = torch.matmul(torch.softmax(sim, -1), v.float()).to(x.dtype)
        return self.o_proj(out.transpose(1, 2).reshape(b, n, self.heads * self.v_dim))


def _recomputing() -> bool:
    """True inside the autograd engine: a block rematerialized in the
    backward runs its forward again there."""
    return torch._C._current_graph_task_id() != -1


class Router(nn.Module):
    """The sigmoid router, in float32: scores s = sigmoid(W_r x) over all
    the experts, each token's top k by s + b (b `e_score_correction_bias`, a
    buffer that only selects), weights the chosen s over their sum times
    `scale`. forward(x [T, dim]) -> (choice Int64[T, k], weight Float32[T, k])."""

    def __init__(self, dim: int, experts: int, top_k: int, scale: float):
        super().__init__()
        self.top_k, self.scale = top_k, scale
        self.weight = nn.Parameter(torch.empty(experts, dim))
        nn.init.normal_(self.weight, std=0.02)
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))

    def forward(self, x):
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        choice = torch.topk(s + self.e_score_correction_bias.float(), self.top_k, dim=-1).indices
        w = s.gather(-1, choice)
        return choice, w / w.sum(-1, keepdim=True) * self.scale


class _Dispatch(torch.autograd.Function):
    """x [T, d] -> its rows in expert order x[tok] [R, d]. The gradient
    gathers each token's rows back (`inv` [T, k]: each assignment's sorted
    row; `held` [T, k]: the assignment is this layer's) and sums them: no
    atomics, the same bits every run."""

    @staticmethod
    def forward(ctx, x, tok, inv, held):
        ctx.save_for_backward(inv, held)
        return x.index_select(0, tok)

    @staticmethod
    def backward(ctx, g):
        inv, held = ctx.saved_tensors
        return torch.where(held[..., None], g[inv], 0).sum(1), None, None, None


class Experts(nn.Module):
    """The held routed experts' SwiGLUs, their weights stacked:
    gate_up_proj [E, 2 inner, dim] (gate rows first), down_proj [E, dim,
    inner]."""

    def __init__(self, experts: int, dim: int, inner: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(experts, 2 * inner, dim))
        self.down_proj = nn.Parameter(torch.empty(experts, dim, inner))
        nn.init.normal_(self.gate_up_proj, std=0.02)
        nn.init.normal_(self.down_proj, std=0.02)

    def grouped(self, xs, offs):
        """Rows xs [R, dim] sorted by expert, offs Int32[E] the groups' ends:
        each group through its expert by two grouped GEMMs. Rows past the
        last end are not multiplied (their output is undefined)."""
        h = torch._grouped_mm(xs, self.gate_up_proj.transpose(-1, -2), offs=offs)
        g, u = h.chunk(2, dim=-1)
        return torch._grouped_mm(F.silu(g) * u, self.down_proj.transpose(-1, -2), offs=offs)

    def one(self, e: int, x):
        g, u = F.linear(x, self.gate_up_proj[e]).chunk(2, dim=-1)
        return F.linear(F.silu(g) * u, self.down_proj[e])


class MoE(nn.Module):
    """DeepSeekMoE over `experts` routed experts, of which the layer holds
    the first `held`, plus the shared experts. `expert_load` (Int64[held],
    on the device) counts the (token, held expert) assignments of every
    forward, summed over calls (a forward recomputed in the backward is not
    counted again)."""

    def __init__(self, dim: int, experts: int, held: int, top_k: int, inner: int, shared: int,
                 scale: float):
        super().__init__()
        if not 0 < held <= experts:
            raise ValueError(f"experts_held={held} of {experts} routed experts")
        self.held, self.top_k = held, top_k
        self.gate = Router(dim, experts, top_k, scale)
        self.experts = Experts(held, dim, inner)
        self.shared_experts = SwiGLU(dim, shared * inner)
        self.register_buffer("expert_load", torch.zeros(held, dtype=torch.int64),
                             persistent=False)

    def grouped(self, x) -> bool:
        """The grouped GEMMs run on the card in bf16; elsewhere the loop."""
        return x.is_cuda and x.dtype == torch.bfloat16

    def plan(self, choice):
        """The assignments in expert order: (order [T k] of the flat
        assignments, offs Int32[held] the groups' ends, inv [T, k] each
        assignment's sorted row, held Bool[T, k]); other ranks' experts sort
        past the last group. Counted into `expert_load`."""
        T, k = choice.shape
        E = self.held
        held = choice < E
        key = torch.where(held, choice, E).reshape(-1)
        order = torch.sort(key, stable=True).indices
        counts = torch.bincount(key, minlength=E + 1)[:E]
        self.count(counts)
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(T * k, device=choice.device)).view(T, k)
        return order, torch.cumsum(counts, 0).to(torch.int32), inv, held

    def loop(self, x, choice, weight):
        """The held experts' part of the output [T, dim], expert by expert."""
        E = self.held
        held = choice < E
        self.count(torch.bincount(choice[held], minlength=E)[:E])
        out = torch.zeros_like(x)
        for e in range(E):
            tok, slot = torch.nonzero(choice == e, as_tuple=True)
            y = self.experts.one(e, x[tok]) * weight[tok, slot, None].to(x.dtype)
            out = out.index_add(0, tok, y)
        return out

    def count(self, counts):
        if not _recomputing():
            self.expert_load += counts

    def forward(self, x):
        b, n, d = x.shape
        xt = x.reshape(b * n, d)
        grouped = self.grouped(xt)
        with span("transfusion.moe.route"):
            choice, weight = self.gate(xt)
            if grouped:
                order, offs, inv, held = self.plan(choice)
        if grouped:
            with span("transfusion.moe.experts"):
                ys = self.experts.grouped(
                    _Dispatch.apply(xt, order // self.top_k, inv, held), offs)
            with span("transfusion.moe.combine"):
                yk = torch.where(held[..., None], ys[inv], 0)  # [T, k, dim]
                routed = torch.bmm(weight.to(x.dtype)[:, None], yk)[:, 0]
        else:
            with span("transfusion.moe.experts"):
                routed = self.loop(xt, choice, weight)
        with span("transfusion.moe.shared"):
            shared = self.shared_experts(x)
        return routed.view(b, n, d) + shared


class MoonlightBlock(nn.Module):
    """One pre-norm layer: MLA, then the layer's feed-forward (a SwiGLU
    below first_k_dense_replace, else `MoE`)."""

    def __init__(self, dim: int, heads: int, cfg: dict, ind: int, attn_impl: str):
        super().__init__()
        eps = cfg["rms_norm_eps"]
        self.input_layernorm = RMSNorm(dim, eps)
        self.self_attn = MLAttention(dim, heads, cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                                     cfg["qk_rope_head_dim"], cfg["v_head_dim"], attn_impl, eps)
        self.post_attention_layernorm = RMSNorm(dim, eps)
        if ind < cfg["first_k_dense_replace"]:
            self.mlp = SwiGLU(dim, cfg["intermediate_size"])
        else:
            self.mlp = MoE(dim, cfg["n_routed_experts"], cfg["experts_held"],
                           cfg["num_experts_per_tok"], cfg["moe_intermediate_size"],
                           cfg["n_shared_experts"], cfg["routed_scaling_factor"])

    def forward(self, x, rope, flash_spec, mask):
        x = x + self.self_attn(self.input_layernorm(x), rope, flash_spec, mask)
        return x + self.mlp(self.post_attention_layernorm(x))

    def float32_modules(self) -> tuple:
        """The sub-modules that stay float32 in a model of any dtype: an
        expert layer's router and selection bias (the modeling code's router
        runs in float32)."""
        return (self.mlp.gate,) if isinstance(self.mlp, MoE) else ()


_NO_PIPELINE = ("block='moonlight' runs no pipeline stages (its layers carry no value residual "
                "and take other inputs than the Transfusion block's)")


class MoonlightTransformer(Transformer):
    """`Transformer` of `MoonlightBlock` layers. `moonlight=` takes
    config.json's keys (`KEYS`); of the base's options it reads dim, depth,
    heads, attn_impl ('flash' or 'dense'), rope_theta, remat and
    remat_policy, and refuses more than one residual stream and dropout."""

    def __init__(self, dim: int, depth: int, moonlight: Optional[dict] = None, **kw):
        if moonlight is None:
            raise ValueError("block='moonlight' takes its shapes as moonlight={...}")
        super().__init__(dim, depth, **kw)
        missing = [k for k in KEYS if k not in moonlight]
        if missing:
            raise ValueError(f"moonlight= lacks {missing}")
        if self.streams != 1 or self.dropout > 0 or self.attn_impl in CONTEXT_PARALLEL:
            raise ValueError("block='moonlight' takes one residual stream, no dropout and "
                             "attn_impl 'flash' or 'dense'")
        self.unet_skips = False
        self.rope_dim = moonlight["qk_rope_head_dim"]
        self.time_in = nn.Linear(dim * 4, dim)
        self.blocks = nn.ModuleList(
            MoonlightBlock(dim, self.heads, moonlight, ind, self.attn_impl)
            for ind in range(depth))
        self.final_norm = RMSNorm(dim, moonlight["rms_norm_eps"])

    def _build_blocks(self, *transfusion_options):
        """Nothing: `__init__` builds the layers from `moonlight=`."""

    def forward(self, x, times=None, times_inst=None, spans=None, is_any_modality=None,
                rotary_pos=None, cache: Optional[dict] = None, causal: bool = False,
                prefill: bool = False, dropout=None):
        """`Transformer.forward`'s uncached call: `trunk_inputs` (rope
        positions 0..n-1 by default), time added to the modality tokens'
        inputs, then the blocks (each rematerialized under `remat` when grad
        is on). Returns (out, None)."""
        if cache is not None or dropout is not None:
            raise NotImplementedError(
                "block='moonlight' runs uncached calls without dropout (its serving needs a "
                "latent KV cache, which the port does not have)")
        if rotary_pos is None:
            rotary_pos = torch.arange(x.shape[1], device=x.device)
        inputs = self.trunk_inputs(x, times, times_inst, spans, causal, is_any_modality,
                                   rotary_pos)
        cond, is_mod = inputs["cond"], inputs["is_any_modality"]
        if cond is not None and is_mod is not None:
            t = self.time_in(cond.to(x.dtype))
            if inputs["cond_index"] is not None:
                t = torch.gather(t, 1, inputs["cond_index"][..., None].expand(-1, -1, x.shape[-1]))
            elif t.ndim == 2:
                t = t[:, None]
            x = x + torch.where(torch.as_tensor(is_mod, device=x.device)[..., None], t, 0)
        remat = self.remat and torch.is_grad_enabled()
        args = (inputs["rope"], inputs["flash_spec"], inputs["mask"])
        for block in self.blocks:
            x = self._remat_block(block, x, *args) if remat else block(x, *args)
        return self.final_norm(x), None

    def value_carry_shape(self, rows: int, n: int, flash_spec) -> tuple:
        raise NotImplementedError(_NO_PIPELINE)

    def run_stage(self, x, values, layers, params: list, inputs: dict):
        raise NotImplementedError(_NO_PIPELINE)
