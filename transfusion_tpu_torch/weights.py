"""Carry the JAX package's parameters into the port.

`from_flax(params_np, model)` takes the flax param tree as a nested dict of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns a
`state_dict` for the port's `TransfusionCore`:

  * `nn.Dense` kernels [in, out] become `nn.Linear.weight` [out, in];
  * `nn.Embed` embeddings become `nn.Embedding.weight`;
  * `block_{i}` becomes `blocks.{i}`; a block's children drop their
    `_{i}` suffix (`attn_3` -> `attn`, `hc_ff_3` -> `hc_ff`: the
    hyper-connections' leaves are not `kernel`s and keep their layout);
    `latent_to_model_{i}` becomes
    `latent_to_model.{i}`; `pos_emb_mlps_{i}/Dense_{j}` becomes
    `pos_emb_mlps.{i}.layers.{j}`;
  * the subtree of a custom modality projection (a
    `pre_post_transformer_enc_dec` module; flax names the pair
    `pre_post_enc_dec_{i}_0` / `_1`, the port holds it at
    `latent_to_model.{i}` / `model_to_latent.{i}`) goes to that torch
    module's own `from_flax(subtree) -> state_dict`;
  * the transformer's `fourier_weights` are carried across, not redrawn.

Only 2-D kernels are mapped here: a conv kernel's layout (flax HWIO,
torch OIHW, and flipped for a transposed conv) is its module's to know,
so a kernel of another rank outside a delegated subtree raises. The key
sets and shapes must match exactly; anything else raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"block_(\d+)")
_INDEXED_LIST = re.compile(r"(latent_to_model|model_to_latent)_(\d+)")
_BLOCK_CHILD = re.compile(r"(skip_proj|attn_ada|ff_ada|hc_attn|hc_ff|attn|ff)_(\d+)")
_PRE_POST = re.compile(r"pre_post_enc_dec_(\d+)_([01])")
_POS_MLP = re.compile(r"pos_emb_mlps_(\d+)")
_DENSE = re.compile(r"Dense_(\d+)")


def _torch_key(path):
    parts = []
    for p in path[:-1]:
        if m := _BLOCK.fullmatch(p):
            parts += ["blocks", m[1]]
        elif m := _POS_MLP.fullmatch(p):
            parts += ["pos_emb_mlps", m[1]]
        elif parts[:1] == ["pos_emb_mlps"] and (m := _DENSE.fullmatch(p)):
            parts += ["layers", m[1]]
        elif m := _INDEXED_LIST.fullmatch(p):
            parts += [m[1], m[2]]
        elif m := _BLOCK_CHILD.fullmatch(p):
            parts.append(m[1])
        else:
            parts.append(p)
    leaf = {"kernel": "weight", "embedding": "weight"}.get(path[-1], path[-1])
    return ".".join(parts + [leaf])


def _projection_slot(key: str):
    """(ModuleList name, index) of a top-level flax key that holds a
    modality projection, else None."""
    if m := _PRE_POST.fullmatch(key):
        return ("latent_to_model", "model_to_latent")[int(m[2])], int(m[1])
    if m := _INDEXED_LIST.fullmatch(key):
        return m[1], int(m[2])
    return None


def from_flax(params_np, model) -> dict:
    """Flax params -> the port's state_dict for `model` (a Transfusion or a
    TransfusionCore)."""
    from transfusion_tpu_torch.models.transfusion import LatentToModel, ModelToLatent

    core = getattr(model, "core", model)
    tree = params_np.get("params", params_np)
    out = {}

    def delegate(name, index, subtree):
        module = getattr(core, name)[index]
        if isinstance(module, (LatentToModel, ModelToLatent)):
            return False
        if not callable(getattr(module, "from_flax", None)):
            raise ValueError(
                f"from_flax: {name}_{index} is a custom {type(module).__name__} without a "
                "from_flax(subtree) -> state_dict method to map its flax parameters")
        for key, val in module.from_flax(subtree).items():
            out[f"{name}.{index}.{key}"] = torch.as_tensor(val, dtype=torch.float32)
        return True

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                slot = None if path else _projection_slot(k)
                if not (slot and delegate(*slot, v)):
                    walk(v, path + [k])
                continue
            arr = np.asarray(v, dtype=np.float32)
            if k == "kernel":
                if arr.ndim != 2:
                    raise ValueError(
                        f"from_flax: {'/'.join(path + [k])} is a rank-{arr.ndim} kernel; only "
                        "dense kernels map here (a conv belongs in a custom module with "
                        "its own from_flax)")
                arr = arr.T
            out[_torch_key(path + [k])] = torch.tensor(arr)

    walk(tree, [])
    expected = core.state_dict()
    missing = sorted(set(expected) - set(out))
    unexpected = sorted(set(out) - set(expected))
    if missing or unexpected:
        raise ValueError(f"from_flax: missing {missing}, unexpected {unexpected}")
    for key, val in out.items():
        if tuple(val.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"from_flax: {key} has shape {tuple(val.shape)}, the port expects "
                f"{tuple(expected[key].shape)}"
            )
    return out
