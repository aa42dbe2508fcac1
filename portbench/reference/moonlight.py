"""The plain float32 reference of the Moonlight-16B-A3B block (DeepSeek-V3,
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json)
inside the port's Transfusion: plain `torch` operations on the benchmark's
weight dict, no kernel, no cache. It imports nothing of the port.

What it computes, with the configuration's keys:

* Text ids are embedded; an image's latent rows go through a linear
  projection (dim_latent -> d) and take its positions, as in
  `reference/model.py`. Departure from the published text model: time
  enters once, at the input. Each image instance's time goes through the
  random Fourier features and SiLU layer of `model.time_condition` (a 4d
  condition), then one linear map (`transformer.time_in`, 4d -> d), added
  to the input vector of each of the image's tokens (the Transfusion
  paper's conditioning of its linear patch encoder, arXiv 2408.11039
  section 3.2).
* num_hidden_layers pre-norm layers: h = x + MLA(RMSNorm(x)),
  y = h + FFN(RMSNorm(h)), RMSNorm = x / sqrt(mean(x^2) + rms_norm_eps) *
  weight.
* MLA (q_lora_rank null): q = W_q x, heads x (qk_nope + qk_rope) columns;
  [c | k_rope] = W_kva x; c RMS-normed with its own weight and eps 1e-6
  (the modeling code builds this norm without the config's eps);
  [k_nope | v] = W_kvb c, heads x (qk_nope + v_head_dim). RoPE (theta
  rope_theta, no scaling) on q's rope columns and on the one k_rope all
  heads share, over the positions of `model.rotary_positions` (an image's
  interior counts once), as interleaved pairs (the modeling code rotates
  de-interleaved halves of the same columns: the same scores). Scores
  q.k / sqrt(qk_nope + qk_rope), no softcap, the Transfusion mask (causal,
  bidirectional inside each image), values of v_head_dim.
* Layers below first_k_dense_replace: a SwiGLU of intermediate_size
  (down(silu(gate x) * up x)). The others DeepSeekMoE (noaux_tc, one
  group): scores s = sigmoid(W_r x) in float32 over the published
  `published.n_routed_experts` experts; each token's num_experts_per_tok
  experts are the top by s + b (b the selection bias, no gradient); their
  weights the chosen s over their sum times routed_scaling_factor. The
  layer holds n_routed_experts of them (the first: the chip's share of an
  expert-parallel deployment) and adds their part, expert by expert, plus
  the n_shared_experts shared experts as one SwiGLU of n_shared_experts x
  moe_intermediate_size. The other experts' part is left out, as the
  program leaves it out.
* The final RMSNorm, an untied head over the port's vocabulary, and the
  joint loss of `reference/model.py` (text cross-entropy, image flow MSE,
  each weighted by its share of the batch's tokens, CFG drop of a row's
  text with probability 0.1).

Attention runs in blocks of query rows and the SwiGLUs in blocks of rows,
each block checkpointed, and with `checkpoint_layers` each layer too, so that the reference fits beside its
optimizer state at the cell's size. `quant` rounds both operands of every
product (the fp8 control). With `ROUTES` set to a list, each call of
`joint_loss` appends its routing choices, one Int64[b n, k] a routed layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import (FLOW_EPS, Q_BLOCK, _ce_block, allowed_mask, linear,
                                       rotary_positions, strict_fp32, time_condition)

__all__ = ["joint_loss", "text_logits", "strict_fp32", "moe", "router"]
LATENT_EPS = 1e-6  # the modeling code's latent norm takes no eps: its default
ROUTES = None  # a list to record each call's routing choices in, or None
ROW_BLOCK = 4096  # rows of a SwiGLU block


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Interleaved rotary embedding of x [b, h, n, d] at positions pos
    [b, n], base theta."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    ang = (pos.to(torch.float32)[..., None] * freqs).repeat_interleave(2, dim=-1)[:, None]
    rot = torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).flatten(-2)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def _attend_block(q, k, v, mask, quant=None):
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p if quant is None else quant(p), v)


def attention(q, k, v, spans, quant=None):
    """softmax(q k^T / sqrt(d) + mask) v over blocks of Q_BLOCK query
    rows; q, k [b, h, n, d], v [b, h, n, dv]; spans None is causal."""
    n = q.shape[2]
    cols = torch.arange(n, device=q.device)
    images = [] if spans is None else [
        (o, o + L) for row in spans.tolist() for _, o, L in row if L > 0]
    outs = []
    for r0 in range(0, n, Q_BLOCK):
        r1 = min(r0 + Q_BLOCK, n)
        c1 = max([r1] + [e for o, e in images if o < r1 and e > r0])
        mask = allowed_mask(cols[r0:r1], cols[:c1], spans)
        args = (q[:, :, r0:r1], k[:, :, :c1], v[:, :, :c1], mask, quant)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_block, *args, use_reentrant=False))
        else:
            outs.append(_attend_block(*args))
    return torch.cat(outs, dim=2)


def mla(W, p, cfg, x, pos, spans, quant):
    b, n, _ = x.shape
    h, nope, rd, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                       cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    q = linear(x, W[p + "q_proj.weight"], quant=quant).view(b, n, h, nope + rd).transpose(1, 2)
    c, k_pe = linear(x, W[p + "kv_a_proj_with_mqa.weight"], quant=quant).split(
        [cfg["kv_lora_rank"], rd], -1)
    c = rms_norm(c, W[p + "kv_a_layernorm.weight"], LATENT_EPS)
    kv = linear(c, W[p + "kv_b_proj.weight"], quant=quant).view(b, n, h, nope + dv)
    k_nope, v = kv.transpose(1, 2).split([nope, dv], -1)
    theta = float(cfg["rope_theta"])
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
    k_pe = rope(k_pe[:, None], pos, theta).expand(b, h, n, rd)
    out = attention(q, torch.cat([k_nope, k_pe], -1), v, spans, quant)
    return linear(out.transpose(1, 2).reshape(b, n, h * dv), W[p + "o_proj.weight"], quant=quant)


def _swiglu(W, p, x, quant):
    g = linear(x, W[p + "gate_proj.weight"], quant=quant)
    u = linear(x, W[p + "up_proj.weight"], quant=quant)
    return linear(F.silu(g) * u, W[p + "down_proj.weight"], quant=quant)


def swiglu(W, p, x, quant):
    """down(silu(gate x) * up x), over blocks of ROW_BLOCK rows of x [b, n,
    d] (each checkpointed), so that the dense layer's [rows, 11264]
    intermediates fit beside the optimizer state."""
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] <= ROW_BLOCK:
        return _swiglu(W, p, x, quant)
    outs = []
    for r0 in range(0, rows.shape[0], ROW_BLOCK):
        args = (W, p, rows[r0:r0 + ROW_BLOCK], quant)
        outs.append(checkpoint(_swiglu, *args, use_reentrant=False) if torch.is_grad_enabled()
                    else _swiglu(*args))
    return torch.cat(outs).view(x.shape)


def router(W, p, cfg, x):
    """(choice Int64[T, k], weight [T, k]) of tokens x [T, d] over the
    published experts, in float32."""
    s = torch.sigmoid(F.linear(x, W[p + "gate.weight"]))
    choice = torch.topk(s + W[p + "gate.e_score_correction_bias"],
                        cfg["num_experts_per_tok"], dim=-1).indices
    w = s.gather(-1, choice)
    return choice, w / w.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]


def moe(W, p, cfg, x, quant=None, routes=None, held=None):
    """The expert layer on x [b, n, d]: the held routed experts' part plus
    the shared experts. `held`: the indices of the experts this layer
    holds (default the first n_routed_experts); the weights of held expert
    j are at row j of the stacked experts."""
    b, n, d = x.shape
    xt = x.reshape(b * n, d)
    choice, weight = router(W, p, cfg, xt)
    if routes is not None:
        routes.append(choice.detach())
    held = range(cfg["n_routed_experts"]) if held is None else held
    out = torch.zeros_like(xt)
    for j, e in enumerate(held):
        tok, slot = torch.nonzero(choice == e, as_tuple=True)
        gu = linear(xt[tok], W[p + "experts.gate_up_proj"][j], quant=quant)
        g, u = gu.chunk(2, dim=-1)
        y = linear(F.silu(g) * u, W[p + "experts.down_proj"][j], quant=quant)
        out = out.index_add(0, tok, y * weight[tok, slot, None])
    return out.view(b, n, d) + swiglu(W, p + "shared_experts.", x, quant)


def _recomputing() -> bool:
    return torch._C._current_graph_task_id() != -1


def block(W, cfg, i, x, pos, spans, quant):
    p = f"transformer.blocks.{i}."
    eps = cfg["rms_norm_eps"]
    x = x + mla(W, p + "self_attn.", cfg, rms_norm(x, W[p + "input_layernorm.weight"], eps),
                pos, spans, quant)
    hx = rms_norm(x, W[p + "post_attention_layernorm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + swiglu(W, p + "mlp.", hx, quant)
    routes = ROUTES[-1] if ROUTES is not None and not _recomputing() else None
    return x + moe(W, p + "mlp.", cfg, hx, quant, routes)


def trunk(W, cfg, x, pos, spans, quant=None, checkpoint_layers=False):
    """The layers and the final norm on x [b, n, d]."""
    if ROUTES is not None:
        ROUTES.append([])
    for i in range(cfg["num_hidden_layers"]):
        args = (W, cfg, i, x, pos, spans, quant)
        if checkpoint_layers and torch.is_grad_enabled():
            x = checkpoint(block, *args, use_reentrant=False)
        else:
            x = block(*args)
    return rms_norm(x, W["transformer.final_norm.weight"], cfg["rms_norm_eps"])


def joint_loss(W, cfg, batch, draws, quant=None, checkpoint_layers=True, prob_uncond=0.1):
    """The joint loss of one packed batch (`reference.packing.pack`), as
    `model.joint_loss`: (total, text_loss, flow_loss)."""
    text, spans, cfg_mask = batch["text"], batch["spans"], batch["cfg_mask"]
    null_id = cfg["num_text_tokens"] + 2
    drop = draws["cfg_uniform"] < prob_uncond
    text = torch.where(drop[:, None] & cfg_mask, null_id, text)
    text_in, labels = text[:, :-1], text[:, 1:]
    b, n = text_in.shape
    dev = text.device

    x = F.embedding(text_in.clamp_min(0), W["text_embed.weight"])
    img_b, img_m, img_off = batch["img_row"], batch["img_inst"], batch["img_off"]
    has_images = len(img_b) > 0
    if has_images:
        t_img = draws["times"][img_b, img_m]
        lat = batch["latents"]
        tb = t_img.view(-1, 1, 1, 1)
        noised = lat * tb + draws["noise"] * (1.0 - tb)
        target = lat - draws["noise"]
        L = lat.shape[1] * lat.shape[2]
        rows_in = linear(noised.reshape(len(img_b), L, -1), W["latent_to_model.0.proj.weight"],
                         W["latent_to_model.0.proj.bias"], quant)
        idx = img_off[:, None] + torch.arange(L, device=dev)[None]
        x = x.index_put((img_b[:, None].expand_as(idx), idx), rows_in)

    inst = torch.arange(n, device=dev)
    off, ln = spans[..., 1][:, :, None], spans[..., 2][:, :, None]
    in_inst = (inst >= off) & (inst < off + ln)  # [b, m, n]
    is_mod = in_inst.any(dim=1)
    cond_all = time_condition(W, cfg, draws["times"], quant)
    cond_index = (in_inst.long() * torch.arange(1, spans.shape[1] + 1, device=dev)[None, :,
                                                                                   None]).sum(1)
    t_in = linear(cond_all, W["transformer.time_in.weight"], W["transformer.time_in.bias"], quant)
    t_tok = torch.gather(t_in, 1, cond_index[..., None].expand(-1, -1, x.shape[-1]))
    x = x + torch.where(is_mod[..., None], t_tok, 0.0)
    pos = rotary_positions(n, spans)

    emb = trunk(W, cfg, x, pos, spans, quant, checkpoint_layers)

    valid = (labels != -1) & (labels != null_id) & ~is_mod
    ce_sum = torch.zeros((), device=dev)
    for r0 in range(0, n, Q_BLOCK):  # the logits in blocks of positions
        e, lab, val = emb[:, r0:r0 + Q_BLOCK], labels[:, r0:r0 + Q_BLOCK], valid[:, r0:r0 + Q_BLOCK]
        ce_sum = ce_sum + checkpoint(_ce_block, e, W["to_text_logits.weight"],
                                     lab.clamp_min(0), val, quant, use_reentrant=False)
    kept = valid.sum().to(torch.float32)
    total_tokens = float(batch["total_tokens"])
    text_loss = ce_sum / kept.clamp_min(1.0)

    flow_loss = torch.zeros((), device=dev)
    if has_images:
        out_rows = emb[img_b[:, None].expand_as(idx), idx]
        flow_in = (out_rows - rows_in) / torch.clamp(1.0 - t_img, min=FLOW_EPS)[:, None, None]
        pred = linear(flow_in, W["model_to_latent.0.proj.weight"], quant=quant)
        flow_loss = ((pred.reshape(target.shape) - target) ** 2).sum() / float(target.numel())
    mod_tokens = is_mod.sum().to(torch.float32)
    total = text_loss * kept / total_tokens + flow_loss * mod_tokens / total_tokens
    return total, text_loss, flow_loss


def text_logits(W, cfg, tokens, quant=None, positions=None):
    """Causal text-only forward of tokens [b, n] -> logits [b, n, V]; with
    `positions` only those positions' logits."""
    b, n = tokens.shape
    x = F.embedding(tokens, W["text_embed.weight"])
    pos = torch.arange(n, device=tokens.device)[None].expand(b, n)
    emb = trunk(W, cfg, x, pos, None, quant)
    if positions is not None:
        emb = emb[:, positions]
    return linear(emb, W["to_text_logits.weight"], quant=quant)

