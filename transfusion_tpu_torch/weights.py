"""Carry the JAX package's parameters into the port.

`from_flax(params_np, model)` takes the flax param tree as a nested dict of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns a
`state_dict` for the port's `TransfusionCore`:

  * `nn.Dense` kernels [in, out] become `nn.Linear.weight` [out, in];
  * `nn.Embed` embeddings become `nn.Embedding.weight`;
  * `block_{i}` becomes `blocks.{i}`; a block's children drop their
    `_{i}` suffix (`attn_3` -> `attn`); `latent_to_model_{i}` becomes
    `latent_to_model.{i}`;
  * the transformer's `fourier_weights` are carried across, not redrawn.

The key sets and shapes must match exactly; anything else raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"block_(\d+)")
_INDEXED_LIST = re.compile(r"(latent_to_model|model_to_latent)_(\d+)")
_BLOCK_CHILD = re.compile(r"(skip_proj|attn_ada|ff_ada|attn|ff)_(\d+)")


def _torch_key(path):
    parts = []
    for p in path[:-1]:
        if m := _BLOCK.fullmatch(p):
            parts += ["blocks", m[1]]
        elif m := _INDEXED_LIST.fullmatch(p):
            parts += [m[1], m[2]]
        elif m := _BLOCK_CHILD.fullmatch(p):
            parts.append(m[1])
        else:
            parts.append(p)
    leaf = {"kernel": "weight", "embedding": "weight"}.get(path[-1], path[-1])
    return ".".join(parts + [leaf])


def from_flax(params_np, model) -> dict:
    """Flax params -> the port's state_dict for `model` (a Transfusion or a
    TransfusionCore)."""
    core = getattr(model, "core", model)
    tree = params_np.get("params", params_np)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            arr = np.asarray(v, dtype=np.float32)
            if k == "kernel":
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
