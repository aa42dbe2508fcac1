"""The benchmark's weights: their values, made on the device from the run's
seed, and how they are copied into the program.

Which tensors a configuration has is its architecture's `spec(cfg)`
(`architectures/<name>.py`; the names are the program's parameter names, so
the weights load by name), and the plain reference reads the same dict.
The values come from one `torch.Generator` on the device in one call: a
single flat draw of standard normals, cut into the drawn leaves in the
spec's order and scaled; the other leaves are constants. The same seed on
the same device gives the same weights, so they can be made again after
the program has been freed instead of being kept.
"""

from __future__ import annotations

import torch

STD = 0.02  # 'normal' leaves: matrices and embeddings
DRAWN = ("normal", "fourier")  # 'fourier': standard normal, always float32


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(arch, cfg: dict, seed: int, device, dtype=torch.float32, names=None) -> dict:
    """{name: tensor} of the weights that the architecture `arch` gives the
    configuration, from `seed`, in `dtype` on `device` (the fourier
    frequencies always float32); a leaf whose init is not drawn holds
    `arch.fill_value(init)`. `names` keeps only those leaves (the draw is
    the same)."""
    leaves = arch.spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    drawn = [(n, s, k) for n, s, k in leaves if k in DRAWN]
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
        if kind not in DRAWN and (names is None or name in names):
            out[name] = torch.full(shape, arch.fill_value(kind), dtype=dtype, device=device)
    return out


def load_into(params: dict, weights: dict):
    """Copy `weights` into the program's tensors `params` {name: tensor}
    (each in the dtype the program keeps it in). Both must name the same
    tensors with the same shapes."""
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
