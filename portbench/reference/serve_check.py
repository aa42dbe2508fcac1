"""The serving cells' check: a sample of the finished requests, each read
once by the plain float32 reference (the architecture's
`reference.text_logits`) over its prompt and the tokens the engine served.
At each served position the reference's logits say how far the served
token lies below the reference's best text token; the number compared is
the widest such gap over the sample (greedy decoding serves the best
token, so a sound run reads only rounding here).

The weights are the run's bf16 weights, made again from the seed and
taken to float32, without the leaves a text-only forward does not read
(the architecture's `unserved_leaves`).

`widest_gap(..., quant=fp8)` is the control: the reference in fp8 puts
its own best token first at each position, and that token's gap under the
float32 reference is read the same way.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference.model import strict_fp32


def reference_weights(arch, cfg: dict, seed: int, device) -> dict:
    names = {n for n, _, _ in arch.spec(cfg)} - arch.unserved_leaves(cfg)
    served = weights.make(arch, cfg, seed, device, getattr(torch, cfg["dtype"]), names=names)
    return {k: served.pop(k).float() for k in list(served)}


def gaps(arch, W: dict, cfg: dict, prompt, tokens, device, quant=None) -> torch.Tensor:
    """The gap below the reference's best text token of each served token
    (quant=None) or of the control's choice (quant given) [len(tokens)]."""
    ids = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int64,
                          device=device)[None]
    P, T = len(prompt), len(tokens)
    positions = torch.arange(P - 1, P + T - 1, device=device)
    N = cfg["num_text_tokens"]
    with torch.no_grad():
        logits = arch.reference.text_logits(W, cfg, ids, positions=positions)[0, :, :N]
        if quant is None:
            chosen = torch.as_tensor(tokens, dtype=torch.int64, device=device)
        else:
            chosen = arch.reference.text_logits(W, cfg, ids, quant=quant,
                                                positions=positions)[0, :, :N]
            chosen = chosen.argmax(dim=-1)
        best = logits.max(dim=-1).values
        return best - logits.gather(-1, chosen[:, None])[:, 0]


def widest_gap(arch, cfg: dict, seed: int, device, sample: list, quant=None) -> float:
    """The widest gap over the sample [(prompt, served tokens)]; an empty
    sample reads infinity (nothing was served)."""
    if not sample:
        return float("inf")
    strict_fp32()
    W = reference_weights(arch, cfg, seed, device)
    return max(float(gaps(arch, W, cfg, p, t, device, quant).max()) for p, t in sample)
