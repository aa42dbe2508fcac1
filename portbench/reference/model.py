"""The plain float32 reference of the Transfusion model the port runs:
plain `torch` operations on the benchmark's weight dict, no kernel, no
cache, no batching trick. It imports nothing of the port.

What it computes, after lucidrains' transfusion-pytorch, which the port
follows (and the departures from the paper's description, Zhou et al. 2024,
arXiv:2408.11039, noted):

* Text ids are embedded; an image's 256 latent rows go through a linear
  projection (32 -> d) and take its positions in the sequence. The paper's
  U-Net / patch encoder is left out: a linear projection, as the paper's
  own "linear" variant.
* Time conditioning: each image instance's time t goes through random
  Fourier features [t, sin(2 pi f t), cos(2 pi f t)] and a SiLU layer to a
  4d condition (not in the paper, which has no per-block conditioning).
* Each block, pre-normed by an adaptive wrapper (not in the paper): text
  rows take LayerNorm(x) * (gamma + 1) in and out * (layerscale + 1);
  image rows take FiLM (LayerNorm(x) * (g + 1) + b, from the condition) in
  and a sigmoid gate out. Blocks of the second half first mix in the
  matching first-half stream through a linear map of [x, skip] (U-Net
  skips, not in the paper).
* Attention: 16 heads, interleaved RoPE over positions in which an image's
  interior counts once, scores scaled by d^-1/2 and soft-capped by
  50 tanh(s / 50), the Transfusion mask (causal, and bidirectional inside
  each image), values mixed with the first layer's values by a learned
  per-head sigmoid (value residual), per-head sigmoid output gates.
* GEGLU feedforward of inner width int(8d / 3), with biases.
* Final RMSNorm (x / |x| sqrt(d) (gamma + 1)), tied to neither embedding.
* Loss: next-token cross-entropy over text labels (not inside an image,
  not the null id), and the flow-matching MSE of each image: the model
  predicts the clean latent x from x_t = t x + (1 - t) noise, the flow is
  (x_hat - x_t) / max(1 - t, 1e-2), its target x - noise. Each term is
  weighted by its share of the batch's tokens. Rows whose CFG draw is
  below 0.1 have their text replaced by the null id.

Attention runs in blocks of query rows, each block checkpointed, and with
`checkpoint_layers` each layer too, so the reference fits at the cells'
sizes. TF32 is switched off by `strict_fp32()`.

`quant`: a function applied to both operands of every product, the
linear layers' and attention's (the control computes in fp8 through it);
None is plain float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SOFTCAP = 50.0
ROPE_THETA = 10000.0
FLOW_EPS = 1e-2
LN_EPS = 1e-5
Q_BLOCK = 512


def strict_fp32():
    """Plain float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def linear(x, w, b=None, quant=None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, b)


def rope(x, pos):
    """Interleaved rotary embedding of x [b, h, n, d] at positions pos
    [b, n]."""
    d = x.shape[-1]
    freqs = 1.0 / (ROPE_THETA ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32)
                                  / d))
    ang = (pos.to(torch.float32)[..., None] * freqs).repeat_interleave(2, dim=-1)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack((-x2, x1), dim=-1).flatten(-2)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def allowed_mask(rows, cols, spans):
    """Bool[b, len(rows), len(cols)]: causal, or both inside one image (a
    row of an image sees the whole image). spans Int[b, m, 3] (type,
    offset, length; length 0 is padding) or None."""
    causal = (rows[:, None] >= cols[None, :])[None]
    if spans is None:
        return causal
    off, ln = spans[..., 1][:, :, None, None], spans[..., 2][:, :, None, None]
    rect = (ln > 0) & (rows[None, None, :, None] >= off) & (
        rows[None, None, :, None] < off + ln) & (cols[None, None, None, :] >= off) & (
        cols[None, None, None, :] < off + ln)
    return causal | rect.any(dim=1)


def _attend_block(q, k, v, mask, quant=None):
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    s = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
    s = torch.tanh(s / SOFTCAP) * SOFTCAP
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p if quant is None else quant(p), v)


def attention(q, k, v, spans, quant=None):
    """softmax(softcap(q k^T / sqrt(d)) + mask) v over blocks of Q_BLOCK
    query rows; q, k, v [b, h, n, d]. `quant` rounds the operands of both
    products."""
    n = q.shape[2]
    cols = torch.arange(n, device=q.device)
    images = [] if spans is None else [
        (o, o + L) for row in spans.tolist() for _, o, L in row if L > 0]
    outs = []
    for r0 in range(0, n, Q_BLOCK):
        r1 = min(r0 + Q_BLOCK, n)
        # the block's rows see no key past its last row or the end of an image they are in
        c1 = max([r1] + [e for o, e in images if o < r1 and e > r0])
        mask = allowed_mask(cols[r0:r1], cols[:c1], spans)
        args = (q[:, :, r0:r1], k[:, :, :c1], v[:, :, :c1], mask, quant)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_block, *args, use_reentrant=False))
        else:
            outs.append(_attend_block(*args))
    return torch.cat(outs, dim=2)


def _gather(t, index):
    """t [b, m + 1, c], index [b, n] -> the rows of each token [b, n, c]."""
    return torch.gather(t, 1, index[..., None].expand(-1, -1, t.shape[-1]))


def adaptive(W, p, x, fn, cond, is_mod, quant):
    """The adaptive wrapper `p` around fn. cond: (the condition of each
    instance [b, m + 1, 4d], each token's instance [b, n]) or None (text
    only)."""
    d = x.shape[-1]
    x_ln = F.layer_norm(x, (d,), eps=LN_EPS)
    text_in = x_ln * (W[p + "layernorm_gamma"] + 1.0)
    if cond is None:
        out, rest = fn(text_in)
        return out * (W[p + "layerscale"] + 1.0), rest
    cond_all, cond_index = cond
    film = _gather(linear(cond_all, W[p + "to_film.weight"], W[p + "to_film.bias"], quant),
                   cond_index)
    gamma, beta = film.chunk(2, dim=-1)
    gate = _gather(torch.sigmoid(linear(cond_all, W[p + "to_ada_ln_zero.weight"],
                                        W[p + "to_ada_ln_zero.bias"], quant)), cond_index)
    sel = is_mod[..., None]
    out, rest = fn(torch.where(sel, x_ln * (gamma + 1.0) + beta, text_in))
    return torch.where(sel, out * gate, out * (W[p + "layerscale"] + 1.0)), rest


def attn_fn(W, p, cfg, pos, spans, value_residual, quant):
    h, dh = cfg["num_attention_heads"], cfg["head_dim"]

    def fn(x):
        b, n, _ = x.shape
        q, k = linear(x, W[p + "to_qk.weight"], quant=quant).chunk(2, dim=-1)
        v = linear(x, W[p + "to_v.weight"], quant=quant)
        q, k, v = (t.view(b, n, h, dh).transpose(1, 2) for t in (q, k, v))
        orig_v = v
        if value_residual is not None:
            mix = torch.sigmoid(linear(x, W[p + "to_value_residual_mix.weight"],
                                       W[p + "to_value_residual_mix.bias"], quant))
            mix = mix.transpose(1, 2)[..., None]
            v = v * mix + value_residual * (1.0 - mix)
        out = attention(rope(q, pos), rope(k, pos), v, spans, quant)
        gates = torch.sigmoid(linear(x, W[p + "to_gates.weight"], quant=quant))
        out = out * gates.transpose(1, 2)[..., None]
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return linear(out, W[p + "to_out.weight"], quant=quant), orig_v

    return fn


def ff_fn(W, p, quant):
    def fn(x):
        hid, gates = linear(x, W[p + "proj_in.weight"], W[p + "proj_in.bias"], quant).chunk(
            2, dim=-1)
        return linear(F.gelu(gates) * hid, W[p + "proj_out.weight"], W[p + "proj_out.bias"],
                      quant), None

    return fn


def block(W, cfg, i, x, skip, cond, is_mod, pos, spans, value_residual, quant):
    p = f"transformer.blocks.{i}."
    if skip is not None:
        x = linear(torch.cat([x, skip], dim=-1), W[p + "skip_proj.weight"], quant=quant) + x
    out, values = adaptive(W, p + "attn_ada.", x,
                           attn_fn(W, p + "attn.", cfg, pos, spans, value_residual, quant),
                           cond, is_mod, quant)
    x = x + out
    out, _ = adaptive(W, p + "ff_ada.", x, ff_fn(W, p + "ff.", quant), cond, is_mod, quant)
    return x + out, values


def trunk(W, cfg, x, cond, is_mod, pos, spans, quant=None, checkpoint_layers=False):
    """The blocks and the final norm on x [b, n, d]."""
    depth = cfg["num_hidden_layers"]
    skips, value_residual = [], None
    for i in range(depth):
        if i + 1 <= depth // 2:
            skips.append(x)
        skip = skips.pop() if i >= depth / 2 else None
        args = (W, cfg, i, x, skip, cond, is_mod, pos, spans, value_residual, quant)
        if checkpoint_layers and torch.is_grad_enabled():
            x, values = checkpoint(block, *args, use_reentrant=False)
        else:
            x, values = block(*args)
        if value_residual is None:
            value_residual = values
    gamma = W["transformer.final_norm.gamma"]
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12) * math.sqrt(x.shape[-1]) * (
        gamma + 1.0)


def time_condition(W, cfg, times, quant=None):
    """times [b, m] -> the condition of [text, instance 1 .. m] [b, m + 1, 4d]."""
    t = torch.cat([torch.zeros_like(times[:, :1]), times], dim=1)
    freqs = t[..., None] * W["transformer.fourier_weights"] * 2.0 * math.pi
    rfe = torch.cat([t[..., None], torch.sin(freqs), torch.cos(freqs)], dim=-1)
    return F.silu(linear(rfe, W["transformer.to_time_cond.weight"],
                         W["transformer.to_time_cond.bias"], quant))


def rotary_positions(n, spans):
    """Positions in which an image's interior (between its first and last
    row) does not advance the count."""
    seq = torch.arange(n, device=spans.device)
    off, ln = spans[..., 1][:, :, None] + 1, spans[..., 2][:, :, None] - 1
    inside = ((seq >= off) & (seq < off + ln)).any(dim=1)
    return seq[None] - torch.cumsum(inside.to(torch.int64), dim=-1)


def joint_loss(W, cfg, batch, draws, quant=None, checkpoint_layers=True, prob_uncond=0.1):
    """The joint loss of one packed batch (`reference.packing.pack`):
    (total, text_loss, flow_loss). draws: times [b, m], cfg_uniform [b],
    noise [k, h, w, c] of the batch's images in (row, instance) order."""
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
    pos = rotary_positions(n, spans)

    emb = trunk(W, cfg, x, (cond_all, cond_index), is_mod, pos, spans, quant, checkpoint_layers)

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


def _ce_block(e, w, labels, valid, quant):
    logits = linear(e, w, quant=quant)
    label_logit = logits.gather(-1, labels[..., None])[..., 0]
    return (-(label_logit - torch.logsumexp(logits, dim=-1)) * valid).sum()


def text_logits(W, cfg, tokens, quant=None, positions=None):
    """Causal text-only forward of tokens [b, n] -> logits [b, n, V] (the
    served path: no image, so every row takes the text branch). With
    `positions` only those positions' logits [b, len, V]."""
    b, n = tokens.shape
    x = F.embedding(tokens, W["text_embed.weight"])
    pos = torch.arange(n, device=tokens.device)[None].expand(b, n)
    emb = trunk(W, cfg, x, None, None, pos, None, quant)
    if positions is not None:
        emb = emb[:, positions]
    return linear(emb, W["to_text_logits.weight"], quant=quant)
