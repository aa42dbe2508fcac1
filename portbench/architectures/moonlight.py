"""The DeepSeek-V3 block of Moonlight-16B-A3B in the port, as the benchmark
knows it: the model (`Transformer(block="moonlight")` inside the port's
Transfusion), the weights it is made of, the plain reference
(`reference/moonlight.py`), the work its layers do, and its rules on a
configuration (`configs/moonlight-16b-a3b.json`, config.json's keys).

The configuration is one chip's share of an expert-parallel deployment:
`n_routed_experts` counts the routed experts held here, and
`published.n_routed_experts` the router's width; `vocab_size` is the
slice of text ids held here. `common.architecture` finds this module by
the configuration's `"architecture": "moonlight"`.
"""

from __future__ import annotations

import torch

from portbench import weights, work
from portbench.reference import moonlight as reference  # noqa: F401 (a hook)

SOURCE = "https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json"
REDUCED = ("n_routed_experts", "vocab_size")  # the chip's share, each stated in `published`
SPECIALS = 3 + 2 + 129  # sos, eos, null; one som and one eom; meta and 128 char tokens


def check_config(cfg: dict):
    """The source is the published config.json; the experts and the
    vocabulary are the chip's share, listed in `reduced` with the
    published numbers beside them; the text ids are the vocabulary slice."""
    if SOURCE not in cfg["source"]:
        raise ValueError(f"{cfg['name']}: the source is not {SOURCE}")
    missing = [k for k in REDUCED if k not in cfg["reduced"] or k not in cfg["published"]]
    if missing:
        raise ValueError(f"{cfg['name']}: {missing} must be in `reduced`, with the published "
                         "numbers under `published`")
    if cfg["num_text_tokens"] != cfg["vocab_size"]:
        raise ValueError(f"{cfg['name']}: num_text_tokens is the vocabulary slice, vocab_size")
    if not 0 < cfg["n_routed_experts"] <= cfg["published"]["n_routed_experts"]:
        raise ValueError(f"{cfg['name']}: n_routed_experts holds a share of the published")


def vocab_size(cfg: dict) -> int:
    """The slice's text ids, then the port's special ids (one modality)."""
    return cfg["num_text_tokens"] + SPECIALS


def model_config(cfg: dict) -> dict:
    """`Transformer(moonlight=...)`: config.json's keys, the router over
    the published experts, `experts_held` the ones held here."""
    from transfusion_tpu_torch.models.moonlight import KEYS

    out = {k: cfg[k] for k in KEYS if k in cfg}
    out["n_routed_experts"] = cfg["published"]["n_routed_experts"]
    out["experts_held"] = cfg["n_routed_experts"]
    return out


def spec(cfg: dict) -> list:
    """[(name, shape, init)] with init 'normal' (std 0.02), 'fourier'
    (standard normal), 'zeros' or 'ones'. The routers' selection biases are
    drawn 'normal', as a trained model's are not zero."""
    d, depth = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, nope, rd, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                       cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    lora, lat, V = cfg["kv_lora_rank"], cfg["dim_latent"], vocab_size(cfg)
    E, held, mi = cfg["published"]["n_routed_experts"], cfg["n_routed_experts"], \
        cfg["moe_intermediate_size"]
    shared = cfg["n_shared_experts"] * mi
    out = [("transformer.fourier_weights", (d // 2,), "fourier"),
           ("transformer.to_time_cond.weight", (4 * d, d + 1), "normal"),
           ("transformer.to_time_cond.bias", (4 * d,), "zeros"),
           ("transformer.time_in.weight", (d, 4 * d), "normal"),
           ("transformer.time_in.bias", (d,), "zeros")]
    for i in range(depth):
        p = f"transformer.blocks.{i}."
        a = p + "self_attn."
        out += [(p + "input_layernorm.weight", (d,), "ones"),
                (a + "q_proj.weight", (h * (nope + rd), d), "normal"),
                (a + "kv_a_proj_with_mqa.weight", (lora + rd, d), "normal"),
                (a + "kv_a_layernorm.weight", (lora,), "ones"),
                (a + "kv_b_proj.weight", (h * (nope + dv), lora), "normal"),
                (a + "o_proj.weight", (d, h * dv), "normal"),
                (p + "post_attention_layernorm.weight", (d,), "ones")]
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            out += _swiglu(m, d, cfg["intermediate_size"])
        else:
            out += [(m + "gate.weight", (E, d), "normal"),
                    (m + "gate.e_score_correction_bias", (E,), "normal"),
                    (m + "experts.gate_up_proj", (held, 2 * mi, d), "normal"),
                    (m + "experts.down_proj", (held, d, mi), "normal")]
            out += _swiglu(m + "shared_experts.", d, shared)
    out += [("transformer.final_norm.weight", (d,), "ones"),
            ("text_embed.weight", (V, d), "normal"),
            ("to_text_logits.weight", (V, d), "normal"),
            ("latent_to_model.0.proj.weight", (d, lat), "normal"),
            ("latent_to_model.0.proj.bias", (d,), "zeros"),
            ("model_to_latent.0.proj.weight", (lat, d), "normal")]
    return out


def _swiglu(p: str, d: int, inner: int) -> list:
    return [(p + "gate_proj.weight", (inner, d), "normal"),
            (p + "up_proj.weight", (inner, d), "normal"),
            (p + "down_proj.weight", (d, inner), "normal")]


def fill_value(kind: str) -> float:
    """The constant of a spec init that is not drawn."""
    return {"zeros": 0.0, "ones": 1.0}[kind]


def build_model(cfg: dict, cell: dict, device):
    """The port's model for the configuration, built on `device`."""
    from transfusion_tpu_torch import Transfusion

    opts = cell.get("model", {})
    if torch.device(device).type == "cuda":
        # the share fills the card: segments that grow in place keep the
        # caching allocator from releasing and reserving blocks again (a
        # synchronisation) as each step's shapes change with its images
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    transformer = dict(dim=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
                       heads=cfg["num_attention_heads"], block="moonlight",
                       moonlight=model_config(cfg), rope_theta=float(cfg["rope_theta"]),
                       attn_impl=cfg["attn_impl"], remat=opts.get("remat", False),
                       remat_policy=opts.get("remat_policy", "full"))
    with torch.device(device):
        return Transfusion(num_text_tokens=cfg["num_text_tokens"], transformer=transformer,
                           dim_latent=cfg["dim_latent"],
                           modality_default_shape=tuple(cfg["latent_shape"]),
                           ce_chunk_size=opts.get("ce_chunk_size"),
                           dtype=getattr(torch, cfg["dtype"]), device=device)


def load_weights(model, W: dict):
    """Copy the spec's weights into the model's core: its parameters, the
    time embedding's Fourier frequencies and the routers' selection biases
    (buffers)."""
    core = model.core
    params = dict(core.named_parameters())
    params.update((n, b) for n, b in core.named_buffers()
                  if n.endswith("fourier_weights") or n.endswith("e_score_correction_bias"))
    weights.load_into(params, W)


_UNSERVED = ("to_time_cond", "time_in", "latent_to_model", "model_to_latent", "fourier_weights")


def unserved_leaves(cfg: dict) -> set:
    """The spec's leaves that a text-only forward does not read."""
    return {n for n, _, _ in spec(cfg) if any(u in n for u in _UNSERVED)}


# -- the work of the block ---------------------------------------------------


def attention_params(cfg: dict) -> int:
    """MLA's four projections: the weights every position multiplies by."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, dv, lora = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                          cfg["kv_lora_rank"])
    return h * (nope + rd) * d + (lora + rd) * d + h * (nope + dv) * lora + d * h * dv


def expert_params(cfg: dict) -> int:
    """One routed (or shared, per its share) expert's SwiGLU weights."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def routed_per_position(cfg: dict) -> float:
    """The held experts' expected assignments a position: its experts per
    token times the held share of the router's experts."""
    return cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / \
        cfg["published"]["n_routed_experts"]


def model_step_params(cfg: dict) -> float:
    """The weights a position multiplies by through the layers: MLA's
    projections; layer 0's dense SwiGLU; each expert layer's router, shared
    experts and its expected share of the held routed experts."""
    d, depth, dense = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    moe = (cfg["published"]["n_routed_experts"] * d
           + (cfg["n_shared_experts"] + routed_per_position(cfg)) * expert_params(cfg))
    return depth * attention_params(cfg) + dense * 3 * d * cfg["intermediate_size"] + \
        (depth - dense) * moe


def attention_pair(cfg: dict) -> tuple[int, int]:
    """(q k widths, value widths) of one visible pair, heads x dim summed
    over the layers: q k 192, values 128."""
    hl = cfg["num_attention_heads"] * cfg["num_hidden_layers"]
    return hl * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]), hl * cfg["v_head_dim"]


def flash_position_bytes(cfg: dict) -> dict:
    """The bytes of one position's q, k (q k wide), v, o (value wide) in
    bf16 and its float32 log-sum-exp, summed over the layers."""
    qk, v = attention_pair(cfg)
    hl = cfg["num_attention_heads"] * cfg["num_hidden_layers"]
    return {"q": 2 * qk, "k": 2 * qk, "v": 2 * v, "o": 2 * v, "lse": 4 * hl}


def cache_slot_bytes(cfg: dict) -> int:
    """The bytes a slot of a latent KV cache would hold in bf16: the normed
    latent and the shared RoPE key, every layer (the port serves no
    Moonlight yet)."""
    return 2 * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * cfg["num_hidden_layers"]


def forward_flops(cfg: dict, w: dict) -> float:
    """The training forward's model FLOPs (2 a multiply-add) of a
    `work.train_step_work` dict: every position through the layers (MLA's
    projections, the router, the shared experts, its expected assignments
    to the held experts), the head on text positions, the latent
    projections on image rows, each image's time conditioning, and
    attention over the visible pairs."""
    d, V = cfg["hidden_size"], vocab_size(cfg)
    flops = 2.0 * model_step_params(cfg) * w["positions"]
    flops += 2.0 * V * d * w["text"]
    flops += 2.0 * 2 * cfg["dim_latent"] * d * w["image_rows"]
    flops += 2.0 * w["images"] * ((d + 1) * 4 * d + 4 * d * d)
    flops += work.attention_flops(attention_pair(cfg), w["pairs"])
    return flops


def serve_flops(cfg: dict, w: dict) -> float:
    """The model FLOPs of a `work.serve_work` dict, as the transfusion
    block counts them (no Moonlight cell serves)."""
    d, V = cfg["hidden_size"], vocab_size(cfg)
    pair = attention_pair(cfg)
    per_pos = 2.0 * model_step_params(cfg)
    f = per_pos * w["prefill_tokens"] + 2.0 * V * d * w["prompts"]
    f += work.attention_flops(pair, w["prefill_pairs"])
    f += (per_pos + 2.0 * V * d) * w["decoded"] + work.attention_flops(pair, w["decode_kv"])
    return f


def expert_flops_and_bytes(cfg: dict, assignments: int, passes: int) -> tuple[float, float]:
    """The held experts' grouped products over `assignments` (token, held
    expert) pairs, `passes` times the forward's work (a forward is one; its
    backward two: the gradients of the rows and of the weights): FLOPs,
    and bytes (every held expert's weights read, the permuted rows read
    and written: d in, 2 inner out; inner in, d out)."""
    d, mi = cfg["hidden_size"], cfg["moe_intermediate_size"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    flops = 2.0 * 3 * d * mi * assignments
    nbytes = 2.0 * (layers * cfg["n_routed_experts"] * 3 * d * mi
                    + assignments * (2 * d + 3 * mi))
    return passes * flops, passes * nbytes
