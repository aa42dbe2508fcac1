"""The control's precision: fp8 (e4m3) operands of every product (the
linear layers', q k^T's and p v's) with one scale a row, the step below the
bf16 the configurations state. The rounding acts in the forward; the
backward passes the gradient straight through."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x):
    s = (x.detach().abs().amax(dim=-1, keepdim=True) / E4M3_MAX).clamp_min(1e-30)
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()
