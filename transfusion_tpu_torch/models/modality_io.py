"""Modules for a modality's input and output: the torch twins of the flax
U-Net halves that `pre_post_transformer_enc_dec` takes, and a
parameter-free patch encoder / decoder (the examples' `PatchEncoder` /
`PatchDecoder`, with a channel axis).

Every module here works on channel-last tensors, as the JAX package's
modules do: a `pre` module maps latents [k, *spatial, d_latent] to model
rows [k, *seq_shape, dim], a `post` module maps them back. A learnable
module carries the JAX package's weights through `from_flax(subtree) ->
state_dict`, which `weights.from_flax` calls on the module's subtree of the
flax tree (`pre_post_enc_dec_{i}_0` for the pre module, `_1` for the post).

flax's `SAME` padding is not torch's: a k3 s2 `nn.Conv` on a 14-wide input
pads (0, 1), and `nn.ConvTranspose` (transpose_kernel=False) correlates the
stride-dilated input with its kernel unflipped over pads (2, 1), which no
`nn.ConvTranspose2d(padding=, output_padding=)` reproduces. The twins pad
and flip explicitly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _flax_leaf(tree: dict, owner: str) -> dict:
    """The {kernel, bias} dict of a one-layer flax subtree, given either
    directly or wrapped in one child (flax's `Conv_0` inside a module)."""
    if "kernel" not in tree and len(tree) == 1:
        tree = next(iter(tree.values()))
    if set(tree) != {"kernel", "bias"}:
        raise ValueError(f"{owner}.from_flax: expected one layer's kernel and bias, got "
                         f"{sorted(tree)}")
    return tree


def _flax_init_(conv, fan_in: int):
    """flax's default initializers: a LeCun-normal kernel (a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in)
    and a zero bias. torch's own init would give the transposed conv twice
    flax's scale (its fan_in counts the output channels)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std)
        nn.init.zeros_(conv.bias)


def _same_pads(size: int, k: int, s: int) -> tuple:
    """flax/XLA `SAME` padding (low, high) of a strided convolution."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Module):
    """flax `nn.Conv(out_ch, (k, k), strides=(s, s), padding="SAME")` on
    channel-last input [b, H, W, in_ch] -> [b, ceil(H/s), ceil(W/s), out_ch],
    initialized as flax initializes it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 2):
        super().__init__()
        self.k, self.s = kernel_size, stride
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride)
        _flax_init_(self.conv, in_ch * kernel_size * kernel_size)

    def forward(self, x):
        x = x.to(self.conv.weight.dtype).permute(0, 3, 1, 2)
        (h0, h1), (w0, w1) = (_same_pads(n, self.k, self.s) for n in x.shape[2:])
        return self.conv(F.pad(x, (w0, w1, h0, h1))).permute(0, 2, 3, 1)

    def from_flax(self, tree: dict) -> dict:
        leaf = _flax_leaf(tree, type(self).__name__)
        kernel = np.asarray(leaf["kernel"], np.float32)  # HWIO
        return {"conv.weight": torch.tensor(kernel.transpose(3, 2, 0, 1).copy()),
                "conv.bias": torch.tensor(np.asarray(leaf["bias"], np.float32))}


class SameConvTranspose2d(nn.Module):
    """flax `nn.ConvTranspose(out_ch, (k, k), strides=(s, s),
    padding="SAME")` on channel-last input [b, H, W, in_ch] -> [b, H*s,
    W*s, out_ch].

    flax runs `lax.conv_transpose(transpose_kernel=False)`: the input
    dilated by s, padded (pad_a, pad_b) per axis, correlated with the
    kernel as it is. `conv_transpose2d` correlates the same dilated input,
    padded k - 1 on both sides, with its weight flipped; so the weight
    holds the flax kernel flipped, and the output drops k - 1 - pad_a rows
    at the low end and k - 1 - pad_b at the high end."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 2):
        super().__init__()
        if stride > kernel_size:
            raise ValueError(f"stride {stride} > kernel size {kernel_size} is not supported")
        self.k, self.s = kernel_size, stride
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride)
        _flax_init_(self.conv, in_ch * kernel_size * kernel_size)
        # lax's `_conv_transpose_padding` for 'SAME'
        pad_len = kernel_size + stride - 2
        pad_a = kernel_size - 1 if stride > kernel_size - 1 else math.ceil(pad_len / 2)
        self.crop = (kernel_size - 1 - pad_a, kernel_size - 1 - (pad_len - pad_a))

    def forward(self, x):
        y = self.conv(x.to(self.conv.weight.dtype).permute(0, 3, 1, 2))
        lo, hi = self.crop
        y = y[:, :, lo: y.shape[2] - hi, lo: y.shape[3] - hi]
        return y.permute(0, 2, 3, 1)

    def from_flax(self, tree: dict) -> dict:
        leaf = _flax_leaf(tree, type(self).__name__)
        kernel = np.asarray(leaf["kernel"], np.float32)[::-1, ::-1]  # HWIO, flipped
        return {"conv.weight": torch.tensor(kernel.transpose(2, 3, 0, 1).copy()),
                "conv.bias": torch.tensor(np.asarray(leaf["bias"], np.float32))}


class PatchEncoder(nn.Module):
    """Images [b, H, W, c] in [0, 1] -> latents [b, H/p, W/p, p*p*c] in
    [-1, 1] (einops `(h p1) (w p2) c -> h w (p1 p2 c)`, then x * 2 - 1)."""

    def __init__(self, patch: int = 2):
        super().__init__()
        self.p = patch

    def forward(self, x):
        b, H, W, c = x.shape
        p = self.p
        x = x.reshape(b, H // p, p, W // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, H // p, W // p, p * p * c) * 2 - 1


class PatchDecoder(nn.Module):
    """The inverse of `PatchEncoder`: latents [b, h, w, p*p*c] -> images
    [b, h*p, w*p, c], mapped from [-1, 1] to [0, 1] and clipped there."""

    def __init__(self, patch: int = 2):
        super().__init__()
        self.p = patch

    def forward(self, x):
        b, h, w, d = x.shape
        p = self.p
        x = x.reshape(b, h, w, p, p, d // (p * p)).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h * p, w * p, d // (p * p))
        return ((x + 1) * 0.5).clamp(0.0, 1.0)
