"""Load transfusion-pytorch checkpoints into the port, and export them
(counterpart of `transfusion_tpu/models/port.py`).

The reference package's `Transfusion` is a torch module whose state_dict
keys follow its module tree (the JAX module's docstring lists them):

  text_embed.weight, to_text_logits.weight
  latent_to_model_projs.{t}[.1].weight/.bias   ('.1' with channel-first latents)
  model_to_latent_projs.{t}[.0].weight
  rotary_emb.freqs                             (validated, not stored here)
  transformer.to_time_cond.0.weights           (the fixed fourier frequencies)
  transformer.to_time_cond.1.weight/.bias
  transformer.layers.{i}.0.weight              (U-Net skip projection)
  transformer.layers.{i}.1.*                   (attention in its adaptive wrapper:
      layernorm_gamma, layerscale, to_film, to_ada_ln_zero, fn.to_qk.0,
      fn.to_v.0, fn.to_learned_value_residual.0 (i > 0), fn.to_gates.0,
      fn.to_out.1)
  transformer.layers.{i}.3.*                   (feedforward: fn.net.0, fn.net.3)
  transformer.norm.gamma

Each maps straight onto one entry of the port's `TransfusionCore`
state_dict: both sides hold torch `[out, in]` Linear weights, the fused
`to_qk` rows are [q; k] and the GEGLU halves (value, gates) on both, so
nothing is transposed or permuted. The time-embedding frequencies are
loaded too, so a ported model conditions on the checkpoint's.

Scope, as in the JAX package: num_residual_streams == 1, no custom
`pre_post_transformer_enc_dec`, no axial positional embedding. The
reference's modality encoders / decoders are not part of the core here and
are skipped (logged). `strict` refuses a missing mapped key and an unused
key outside the skipped ones.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger("transfusion_tpu_torch")

# reference keys with no counterpart in the core: the derived rotary
# schedule (validated instead), the frozen encoders / decoders, and buffers
_IGNORED_PREFIXES = ("rotary_emb.", "modality_encoder", "modality_decoder", "zero",
                     "text_only_logits_mask")


def reference_key_map(model) -> list:
    """[(reference key, port state_dict key)] for `model`'s configuration."""
    cfg = model.transformer_cfg
    depth = cfg["depth"]
    if cfg.get("num_residual_streams", 1) != 1:
        raise ValueError("porting is only defined for num_residual_streams=1 (the reference "
                         "default; multi-stream hyper-connection parameterizations differ)")
    if any(p is not None for p in model.pre_post):
        raise ValueError("cannot port models with custom pre_post_transformer_enc_dec: the "
                         "reference stores arbitrary user modules there")
    if any(mc.add_pos_emb for mc in model.modalities):
        raise ValueError("porting axial positional embedding MLPs is not supported")

    mapping = [
        ("text_embed.weight", "text_embed.weight"),
        ("to_text_logits.weight", "to_text_logits.weight"),
        ("transformer.to_time_cond.0.weights", "transformer.fourier_weights"),
        ("transformer.to_time_cond.1.weight", "transformer.to_time_cond.weight"),
        ("transformer.to_time_cond.1.bias", "transformer.to_time_cond.bias"),
        ("transformer.norm.gamma", "transformer.final_norm.gamma"),
    ]
    for t, mc in enumerate(model.modalities):
        l_infix = ".1" if mc.channel_first_latent else ""
        m_infix = ".0" if mc.channel_first_latent else ""
        if mc.dim_latent != model.dim:  # else an identity on both sides
            mapping += [(f"latent_to_model_projs.{t}{l_infix}.{w}", f"latent_to_model.{t}.proj.{w}")
                        for w in ("weight", "bias")]
        mapping.append((f"model_to_latent_projs.{t}{m_infix}.weight",
                        f"model_to_latent.{t}.proj.weight"))

    for i in range(depth):
        ref, blk = f"transformer.layers.{i}", f"transformer.blocks.{i}"
        if cfg.get("unet_skips", True) and i >= depth / 2:
            mapping.append((f"{ref}.0.weight", f"{blk}.skip_proj.weight"))
        for slot, ada, fn in (("1", "attn_ada", "attn"), ("3", "ff_ada", "ff")):
            a = f"{ref}.{slot}"
            mapping += [(f"{a}.{w}", f"{blk}.{ada}.{w}") for w in (
                "layernorm_gamma", "layerscale", "to_film.weight", "to_film.bias",
                "to_ada_ln_zero.weight", "to_ada_ln_zero.bias")]
        attn, ff = f"{ref}.1.fn", f"{ref}.3.fn"
        mapping += [
            (f"{attn}.to_qk.0.weight", f"{blk}.attn.to_qk.weight"),
            (f"{attn}.to_v.0.weight", f"{blk}.attn.to_v.weight"),
            (f"{attn}.to_out.1.weight", f"{blk}.attn.to_out.weight"),
        ]
        if cfg.get("attn_gate_values", True):
            mapping.append((f"{attn}.to_gates.0.weight", f"{blk}.attn.to_gates.weight"))
        if i > 0:  # the learned value-residual mix
            mapping += [(f"{attn}.to_learned_value_residual.0.{w}",
                         f"{blk}.attn.to_value_residual_mix.{w}") for w in ("weight", "bias")]
        mapping += [
            (f"{ff}.net.0.weight", f"{blk}.ff.proj_in.weight"),
            (f"{ff}.net.0.bias", f"{blk}.ff.proj_in.bias"),
            (f"{ff}.net.3.weight", f"{blk}.ff.proj_out.weight"),
            (f"{ff}.net.3.bias", f"{blk}.ff.proj_out.bias"),
        ]
    return mapping


def _to_f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device="cpu", dtype=torch.float32)
    return torch.tensor(np.asarray(v, dtype=np.float32))


def _rotary_freqs(model) -> torch.Tensor:
    dh = model.transformer_cfg.get("dim_head", 64)
    theta = model.transformer_cfg.get("rope_theta", 10000.0)
    return torch.tensor(1.0 / theta ** (np.arange(0, dh, 2, dtype=np.float32) / dh))


def _validate_rotary(state_dict, model):
    if "rotary_emb.freqs" not in state_dict:
        return
    freqs, want = _to_f32(state_dict["rotary_emb.freqs"]), _rotary_freqs(model)
    if freqs.shape != want.shape or not torch.allclose(freqs, want, rtol=1e-4):
        raise ValueError(
            "reference checkpoint uses a non-default (learned or custom-theta) rotary "
            "frequency schedule; set transformer rope_theta to match or retrain: the port "
            "derives rotary frequencies instead of storing them")


def port_from_reference(state_dict, model, strict: bool = True) -> dict:
    """Load a transfusion-pytorch state_dict (torch tensors or numpy
    arrays) into `model` (a port `Transfusion` of the checkpoint's
    configuration). Entries the map does not reach keep the model's own
    values. Returns the core's new state_dict (float32 on the CPU)."""
    sd = dict(state_dict)
    _validate_rotary(sd, model)
    skipped = sorted({k.split(".")[0] for k in sd
                      if k.startswith(("modality_encoder", "modality_decoder"))})
    if skipped:
        logger.warning("port_from_reference: skipped the reference's %s; pass the port's "
                       "own modules as modality_encoder / modality_decoder", skipped)

    core = model.core
    out = {k: v.detach().to(device="cpu", dtype=torch.float32).clone()
           for k, v in core.state_dict().items()}
    consumed = set()
    for ref_key, key in reference_key_map(model):
        if ref_key not in sd:
            if strict:
                raise KeyError(f"reference checkpoint is missing '{ref_key}'")
            continue
        v = _to_f32(sd[ref_key])
        if tuple(v.shape) != tuple(out[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {tuple(v.shape)} vs model "
                             f"{tuple(out[key].shape)}")
        out[key] = v.clone()
        consumed.add(ref_key)
    leftovers = [k for k in sd if k not in consumed and not k.startswith(_IGNORED_PREFIXES)]
    if leftovers and strict:
        raise ValueError(f"unrecognized reference keys (config mismatch?): {leftovers[:8]}")
    core.load_state_dict(out)
    return out


def export_to_reference(model, params: dict | None = None) -> dict:
    """The inverse of `port_from_reference`: `params` (a core state_dict or
    a trainer state's master weights; default: `model`'s own weights) as a
    transfusion-pytorch state_dict of float32 CPU tensors, with the
    rotary schedule the reference stores."""
    params = {**model.core.state_dict(), **(params or {})}
    out = {ref_key: _to_f32(params[key]).clone()
           for ref_key, key in reference_key_map(model)}
    out["rotary_emb.freqs"] = _rotary_freqs(model)
    return out
