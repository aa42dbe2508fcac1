"""The port's Transfusion block as the benchmark knows it: the model built
from a configuration, the weights (the spec that the seed's one draw is cut
into, and how they load), the leaves a text-only forward reads, the plain
reference (`reference/model.py`), the work its layers do, and its rules on
a configuration.

The harness reaches the block only through this module, which
`common.architecture` finds by the configuration's `architecture` (none:
this one). Another architecture is another file of `architectures/` with the
names that `common.HOOKS` lists.
"""

from __future__ import annotations

import torch

from portbench import weights, work
from portbench.reference import model as reference  # noqa: F401 (a hook)

PAPER = "2408.11039"  # arXiv id of the Transfusion paper the configurations follow
ADA_GATE_BIAS = -2.0  # the port's init of the image branch's output gate


def check_config(cfg: dict):
    """The block's rules on a configuration: the heads fill the width, and
    the source is the Transfusion paper."""
    if cfg["hidden_size"] != cfg["num_attention_heads"] * cfg["head_dim"]:
        raise ValueError(f"{cfg['name']}: hidden_size {cfg['hidden_size']} is not "
                         f"num_attention_heads x head_dim")
    if PAPER not in cfg["source"]:
        raise ValueError(f"{cfg['name']}: the source names no arXiv {PAPER}")


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


def fill_value(kind: str) -> float:
    """The constant of a spec init that is not drawn."""
    return {"zeros": 0.0, "gate_bias": ADA_GATE_BIAS}[kind]


def build_model(cfg: dict, cell: dict, device):
    """The port's model for the configuration, built on `device` (the
    constructor then initialises there, not on the host) and loaded with
    the weights the caller makes."""
    from transfusion_tpu_torch import Transfusion

    opts = cell.get("model", {})
    transformer = dict(dim=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
                       dim_head=cfg["head_dim"], heads=cfg["num_attention_heads"],
                       ff_expansion_factor=cfg["ff_expansion_factor"],
                       attn_impl=cfg["attn_impl"], remat=opts.get("remat", False),
                       remat_policy=opts.get("remat_policy", "full"))
    dtype = getattr(torch, cfg["dtype"])
    with torch.device(device):
        return Transfusion(num_text_tokens=cfg["num_text_tokens"], transformer=transformer,
                           dim_latent=cfg["dim_latent"],
                           modality_default_shape=tuple(cfg["latent_shape"]),
                           ce_chunk_size=opts.get("ce_chunk_size"), dtype=dtype,
                           device=device)


def load_weights(model, W: dict):
    """Copy the spec's weights into the model's core: its parameters and
    the time embedding's Fourier frequencies, a buffer."""
    core = model.core
    params = dict(core.named_parameters())
    params["transformer.fourier_weights"] = core.transformer.fourier_weights
    weights.load_into(params, W)


# the leaves a text-only forward does not read
_UNSERVED = ("to_film", "to_ada_ln_zero", "to_time_cond", "latent_to_model", "model_to_latent",
             "fourier_weights")


def unserved_leaves(cfg: dict) -> set:
    """The spec's leaves that the serving check leaves unloaded."""
    return {n for n, _, _ in spec(cfg) if any(u in n for u in _UNSERVED)}


# -- the work of the block ---------------------------------------------------


def block_matmul_params(cfg: dict, i: int) -> int:
    """The weights that every position of block i multiplies by."""
    d, h, dh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["head_dim"]
    inner = h * dh
    fi = ff_inner(cfg)
    p = 2 * inner * d + inner * d + inner * d + h * d + (h * d if i > 0 else 0)
    p += 2 * fi * d + fi * d
    if i >= cfg["num_hidden_layers"] / 2:
        p += 2 * d * d
    return p


def model_step_params(cfg: dict) -> int:
    """The weights a text position multiplies by through the blocks."""
    return sum(block_matmul_params(cfg, i) for i in range(cfg["num_hidden_layers"]))


def attention_pair(cfg: dict) -> tuple[int, int]:
    """(q k widths, value widths) of one visible pair, each heads x dim,
    summed over the layers (every block attends, q, k and v share a head
    dim)."""
    inner = cfg["num_attention_heads"] * cfg["head_dim"] * cfg["num_hidden_layers"]
    return inner, inner


def flash_position_bytes(cfg: dict) -> dict:
    """The bytes of one position's q, k, v and o in bf16 and its float32
    log-sum-exp, summed over the layers."""
    h, depth = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    row = 2 * h * cfg["head_dim"] * depth
    return {"q": row, "k": row, "v": row, "o": row, "lse": 4 * h * depth}


def cache_slot_bytes(cfg: dict) -> int:
    """The bytes one slot of the bf16 KV cache holds: K and V, every layer."""
    return 2 * 2 * cfg["num_attention_heads"] * cfg["head_dim"] * cfg["num_hidden_layers"]


def forward_flops(cfg: dict, w: dict) -> float:
    """The training forward's model FLOPs (2 a multiply-add) of a
    `work.train_step_work` dict: every position through the blocks, the
    text head on text positions, the latent projections on image rows, the
    conditioning of each image, and attention over the visible pairs."""
    d, V = cfg["hidden_size"], vocab_size(cfg)
    depth = cfg["num_hidden_layers"]
    flops = 2.0 * model_step_params(cfg) * w["positions"]
    flops += 2.0 * V * d * w["text"]
    flops += 2.0 * 2 * cfg["dim_latent"] * d * w["image_rows"]
    flops += 2.0 * w["images"] * ((d + 1) * 4 * d + depth * 2 * 12 * d * d)
    flops += work.attention_flops(attention_pair(cfg), w["pairs"])
    return flops


def serve_flops(cfg: dict, w: dict) -> float:
    """The model FLOPs of a `work.serve_work` dict. A prompt of P tokens:
    every position through the blocks, causal attention over its pairs, the
    text head once (its last position). A decoded token: one position
    through the blocks and the head, attention over the slots it reads."""
    d, V = cfg["hidden_size"], vocab_size(cfg)
    pair = attention_pair(cfg)
    per_pos = 2.0 * model_step_params(cfg)
    f = per_pos * w["prefill_tokens"] + 2.0 * V * d * w["prompts"]
    f += work.attention_flops(pair, w["prefill_pairs"])
    f += (per_pos + 2.0 * V * d) * w["decoded"] + work.attention_flops(pair, w["decode_kv"])
    return f
