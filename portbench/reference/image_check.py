"""The image-serving cells' check: a sample of the finished requests, each
integrated again by the plain float32 reference (the architecture's
`reference.trunk` and `time_condition`, `reference/model.py`) from the same
caption (after the sos) and initial noise, over the same grid (`modality_steps` points from
0 to 1, a midpoint step between each two) with the same classifier-free
guidance (`cfg_scale`; the unconditional twin is the caption with every id
nulled). At each evaluation the reference reads the caption and the
image's latent rows at time t as one sequence: the caption causal, the
rows seeing the caption and each other, at one rotary position, the rows
conditioned on t; the flow is the x-prediction's (x_hat - x_t) / max(1 -
t, eps) taken back to the latent. The number compared is the widest
relative L2 gap of a served latent from the reference's (`image_gap`).

The weights are the run's bf16 weights, made again from the seed and taken
to float32. `widest_gap(..., quant=fp8)` is the control: the reference in
fp8 in the program's place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.model import FLOW_EPS, linear, rotary_positions, strict_fp32



def reference_weights(arch, cfg: dict, seed: int, device) -> dict:
    served = weights.make(arch, cfg, seed, device, getattr(torch, cfg["dtype"]))
    return {k: served.pop(k).float() for k in list(served)}


def image_flow(arch, W: dict, cfg: dict, ids, y, t: float, quant=None):
    """The flow of the latent y [h, w, c] at time t after each caption of
    ids [b, P] (one forward of b rows): [b, h, w, c]."""
    ref = arch.reference
    b, P = ids.shape
    h, w, c = y.shape
    L = h * w
    rows = linear(y.reshape(L, c), W["latent_to_model.0.proj.weight"],
                  W["latent_to_model.0.proj.bias"], quant)
    x = torch.cat([F.embedding(ids, W["text_embed.weight"]), rows.expand(b, L, rows.shape[-1])],
                  dim=1)
    n = P + L
    spans = torch.tensor([[[0, P, L]]] * b, device=ids.device)
    cond = ref.time_condition(W, cfg, torch.full((b, 1), float(t), device=ids.device), quant)
    is_mod = (torch.arange(n, device=ids.device) >= P)[None].expand(b, n)
    emb = ref.trunk(W, cfg, x, (cond, is_mod.long()), is_mod, rotary_positions(n, spans), spans,
                    quant)
    flow = (emb[:, P:] - rows) / max(1.0 - float(t), FLOW_EPS)
    return linear(flow, W["model_to_latent.0.proj.weight"], quant=quant).view(b, h, w, c)


def integrate(arch, W: dict, cfg: dict, cell: dict, prompt, noise, quant=None):
    """The reference's latent of one request from its initial noise."""
    eng = cell["engine"]
    scale = float(eng.get("cfg_scale", 3.0))
    sos = cfg["num_text_tokens"]  # the engine's sos, before the caption
    ids = torch.as_tensor([sos, *prompt], dtype=torch.int64, device=noise.device)
    ids = torch.stack([ids, torch.full_like(ids, sos + 2)])

    def flow(t, y):
        f = image_flow(arch, W, cfg, ids, y, t, quant)
        return f[1] + scale * (f[0] - f[1])

    grid = torch.linspace(0.0, 1.0, int(eng.get("modality_steps", 16)), dtype=torch.float32)
    y = noise.float()
    for i in range(grid.shape[0] - 1):
        t0, dt = grid[i], grid[i + 1] - grid[i]
        half = dt * 0.5
        k1 = flow(t0, y)
        y = y + dt * flow(t0 + half, y + half * k1)
    return y


def altered(latent):
    """The planted fault: the served latent with its first quarter of rows
    of positions zeroed (at least one)."""
    out = latent.copy()
    out[:max(1, len(out) // 4)] = 0.0
    return out


def widest_gap(arch, cfg: dict, cell: dict, traffic: dict, seed: int, device, sample: list,
               quant=None) -> float:
    """The widest relative L2 gap over the sample [{'prompt', 'noise',
    'latent'}] of a served latent (with `quant`: the control's) from the
    float32 reference's; an empty sample reads infinity."""
    if not sample:
        return float("inf")
    strict_fp32()
    W = reference_weights(arch, cfg, seed, device)
    gap = 0.0
    with torch.no_grad():
        for r in sample:
            want = integrate(arch, W, cfg, cell, r["prompt"], r["noise"].to(device))
            got = (integrate(arch, W, cfg, cell, r["prompt"], r["noise"].to(device), quant)
                   if quant is not None else torch.as_tensor(r["latent"], device=device).float())
            gap = max(gap, float((got - want).norm() / want.norm()))
    return gap
