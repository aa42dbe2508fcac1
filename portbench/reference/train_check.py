"""The training cells' check: the plain float32 reference (the
architecture's `reference.joint_loss`) follows the program's first three
steps on the same weights, rows and draws, with the update the
configuration states (clip by global norm, then Adam), and the program's
readings are held against it.

The numbers compared, each with a limit of its own (the cell's `limits`):

* loss_gap: the largest |program - reference| / |reference| of the three
  steps' losses;
* grad_gap: the first step's gradient as the optimizer got it (clipped),
  leaf by leaf: the largest |norm(program) - norm(reference)| over the
  larger of the reference leaf's norm and the median leaf's;
* update_gap: each leaf's change after three steps, the same way, over the
  leaves whose reference gradient is above a thousandth of the median
  leaf's (a leaf whose gradient is nought to rounding moves under Adam by
  round-off alone).

`follow` also serves the control (`quant`, the reference in fp8) and the
planted fault of half the batch left out (`half`).
"""

from __future__ import annotations

import statistics

import torch

from portbench import weights
from portbench.reference.model import strict_fp32
from portbench.reference.packing import pack

ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}
GRAD_CLIP = 0.5
STILL = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _merge_draws(draws: list, m: int) -> dict:
    """The microbatches' draws as one batch's: rows in order, times padded
    to m instances."""
    times = torch.cat([torch.nn.functional.pad(d["times"], (0, m - d["times"].shape[1]))
                       for d in draws])
    return {"times": times, "cfg_uniform": torch.cat([d["cfg_uniform"] for d in draws]),
            "noise": torch.cat([d["noise"] for d in draws])}


def follow(arch, cfg: dict, seed: int, device, step_rows: list, step_draws: list, n: int,
           names: list, lr: float, quant=None, half: bool = False) -> dict:
    """The reference's readings of the steps: {'loss': [...], 'grad':
    {leaf: norm}, 'change': {leaf: norm}}. step_rows[s]: the step's rows
    (samples); step_draws[s]: its microbatches' draws."""
    strict_fp32()
    W = weights.make(arch, cfg, seed, device, torch.float32)
    init = {k: W[k].clone() for k in names}
    params = {k: W[k].requires_grad_(True) for k in names}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    out = {"loss": [], "grad": None, "change": None}
    for s, (rows, draws) in enumerate(zip(step_rows, step_draws)):
        batch = pack(rows, n, cfg["num_text_tokens"], device)
        d = _merge_draws(draws, batch["spans"].shape[1])
        if half:
            keep = len(rows) // 2
            batch = pack(rows[:keep], n, cfg["num_text_tokens"], device)
            k_img = int((batch["img_row"] >= 0).sum())
            d = {"times": d["times"][:keep, :batch["spans"].shape[1]],
                 "cfg_uniform": d["cfg_uniform"][:keep], "noise": d["noise"][:k_img]}
        loss, _, _ = arch.reference.joint_loss(W, cfg, batch, d, quant=quant)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            # a leaf the step does not reach (the image projections of a
            # step without images) has a zero gradient
            g = {k: torch.zeros_like(params[k]) if x is None else x
                 for k, x in zip(params, grads)}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
            scale = 1.0 if norm < GRAD_CLIP else GRAD_CLIP / float(norm)
            g = {k: x * scale for k, x in g.items()}
            if s == 0:
                out["grad"] = {k: float(x.norm()) for k, x in g.items()}
            t = s + 1
            for k, p in params.items():
                mu[k].mul_(ADAM["b1"]).add_(g[k], alpha=1 - ADAM["b1"])
                nu[k].mul_(ADAM["b2"]).addcmul_(g[k], g[k], value=1 - ADAM["b2"])
                mu_hat = mu[k] / (1 - ADAM["b1"] ** t)
                nu_hat = nu[k] / (1 - ADAM["b2"] ** t)
                p.sub_(lr * mu_hat / (nu_hat.sqrt() + ADAM["eps"]))
        del grads, g, loss
    with torch.no_grad():
        out["change"] = {k: float((params[k] - init[k]).norm()) for k in names}
    return out


def compare(prog: dict, reference: dict, names: list) -> dict:
    """The numbers of the module docstring, each leaf-wise one also as the
    median over the leaves (`*_median`), and the first step's loss alone
    (`loss_gap_first`); a cell's `limits` say which it compares."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], reference["loss"])]
    med_g = statistics.median(reference["grad"][k] for k in names)
    grad = [abs(prog["grad"][k] - reference["grad"][k])
            / max(reference["grad"][k], med_g, 1e-30) for k in names]
    moving = [k for k in names if reference["grad"][k] >= STILL * med_g]
    med_c = statistics.median(reference["change"][k] for k in moving)
    update = [abs(prog["change"][k] - reference["change"][k])
              / max(reference["change"][k], med_c, 1e-30) for k in moving]
    return {"loss_gap": max(losses), "loss_gap_first": losses[0], "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad), "update_gap": max(update),
            "update_gap_median": statistics.median(update)}


def check(arch, cfg: dict, cell: dict, traffic: dict, seed: int, device, step_rows: list,
          step_draws: list, program: dict, names: list) -> dict:
    """{number: {'value', 'limit'}} of the program's readings against the
    reference's, with the cell's limits."""
    reference = follow(arch, cfg, seed, device, step_rows, step_draws, traffic["row_len"] + 1,
                       names, cell.get("trainer", {}).get("learning_rate", 3e-4))
    gaps = compare(program, reference, names)
    return {k: {"value": gaps[k], "limit": v} for k, v in cell["limits"].items()}
