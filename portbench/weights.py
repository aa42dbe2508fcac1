"""The benchmark's weights: which tensors a configuration has, and their
values, made on the device from the run's seed.

The spec is the benchmark's own account of the port's block (the names are
the port's parameter names, so the weights load by name), and the plain
reference reads the same dict. The values come from one `torch.Generator`
on the device in one call per init kind: a single flat draw of standard
normals, cut into the leaves and scaled. The same seed on the same device
gives the same weights, so they can be made again after the program has
been freed instead of being kept.
"""

from __future__ import annotations

import torch

STD = 0.02  # matrices and embeddings
ADA_GATE_BIAS = -2.0  # the port's init of the image branch's output gate


def vocab_size(cfg: dict) -> int:
    """Text ids, then sos, eos, null, one som and one eom a modality, meta
    and 128 char tokens (the port's id layout, one modality)."""
    return cfg["num_text_tokens"] + 3 + 2 + 129


def ff_inner(cfg: dict) -> int:
    return int(cfg["hidden_size"] * cfg["ff_expansion_factor"] * 2 / 3)


def spec(cfg: dict) -> list:
    """[(name, shape, init)] with init 'normal' (std 0.02), 'fourier'
    (standard normal), 'zeros' or 'gate_bias'."""
    d, depth = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, dh = cfg["num_attention_heads"], cfg["head_dim"]
    inner, fi, lat = h * dh, ff_inner(cfg), cfg["dim_latent"]
    V = vocab_size(cfg)
    out = [("transformer.fourier_weights", (d // 2,), "fourier"),
           ("transformer.to_time_cond.weight", (4 * d, d + 1), "normal"),
           ("transformer.to_time_cond.bias", (4 * d,), "zeros")]
    for i in range(depth):
        p = f"transformer.blocks.{i}."
        if i >= depth / 2:
            out.append((p + "skip_proj.weight", (d, 2 * d), "normal"))
        out += [(p + "attn.to_qk.weight", (2 * inner, d), "normal"),
                (p + "attn.to_v.weight", (inner, d), "normal")]
        if i > 0:
            out += [(p + "attn.to_value_residual_mix.weight", (h, d), "normal"),
                    (p + "attn.to_value_residual_mix.bias", (h,), "zeros")]
        out += [(p + "attn.to_gates.weight", (h, d), "normal"),
                (p + "attn.to_out.weight", (d, inner), "normal"),
                (p + "ff.proj_in.weight", (2 * fi, d), "normal"),
                (p + "ff.proj_in.bias", (2 * fi,), "zeros"),
                (p + "ff.proj_out.weight", (d, fi), "normal"),
                (p + "ff.proj_out.bias", (d,), "zeros")]
        for ada in ("attn_ada", "ff_ada"):
            q = p + ada + "."
            out += [(q + "layernorm_gamma", (d,), "zeros"),
                    (q + "layerscale", (d,), "zeros"),
                    (q + "to_film.weight", (2 * d, 4 * d), "normal"),
                    (q + "to_film.bias", (2 * d,), "zeros"),
                    (q + "to_ada_ln_zero.weight", (d, 4 * d), "normal"),
                    (q + "to_ada_ln_zero.bias", (d,), "gate_bias")]
    out += [("transformer.final_norm.gamma", (d,), "zeros"),
            ("text_embed.weight", (V, d), "normal"),
            ("to_text_logits.weight", (V, d), "normal"),
            ("latent_to_model.0.proj.weight", (d, lat), "normal"),
            ("latent_to_model.0.proj.bias", (d,), "zeros"),
            ("model_to_latent.0.proj.weight", (lat, d), "normal")]
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(cfg: dict, seed: int, device, dtype=torch.float32, names=None) -> dict:
    """{name: tensor} of the configuration's weights from `seed`, in
    `dtype` on `device` (the fourier frequencies always float32). `names`
    keeps only those leaves (the draw is the same)."""
    leaves = spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    drawn = [(n, s, k) for n, s, k in leaves if k in ("normal", "fourier")]
    flat = torch.randn(sum(numel(s) for _, s, _ in drawn), generator=gen, device=device,
                       dtype=dtype)
    out, off = {}, 0
    for name, shape, kind in drawn:
        n = numel(shape)
        if names is None or name in names:
            leaf = flat[off:off + n].view(shape)
            if kind == "normal":
                out[name] = leaf.mul_(STD)  # a view: the draw is not held twice
            else:
                out[name] = leaf.float().clone()
        off += n
    del flat
    for name, shape, kind in leaves:
        if kind in ("zeros", "gate_bias") and (names is None or name in names):
            fill = ADA_GATE_BIAS if kind == "gate_bias" else 0.0
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return out


def load_into(core, weights: dict):
    """Copy `weights` into the port's core (each in the dtype the core
    keeps it in). The spec and the core must name the same tensors with the
    same shapes."""
    params = dict(core.named_parameters())
    params["transformer.fourier_weights"] = core.transformer.fourier_weights
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"weight spec and model differ: model only {missing[:5]}, "
                         f"spec only {extra[:5]}")
    with torch.no_grad():
        for name, t in params.items():
            if tuple(t.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: model {tuple(t.shape)}, spec "
                                 f"{tuple(weights[name].shape)}")
            t.copy_(weights[name])
