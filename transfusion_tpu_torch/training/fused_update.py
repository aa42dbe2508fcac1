"""Clip + Adam + EMA in one pass over the parameters (counterpart of
`transfusion_tpu/training/fused_update.py`, which is plain XLA, not a
Pallas kernel).

The same math in the optax op order that the JAX module mirrors
(`optax.chain(clip_by_global_norm(c), adam(lr))` + `ema_update`):

  * clip: g_c = select(norm < c, g, (g / norm) * c), norm the global L2
    norm of all grads (returned for the metrics);
  * Adam with the bias correction 1 - b ** count at the integer count,
    update = -lr * (mu_hat / (sqrt(nu_hat) + eps));
  * EMA as an a/b blend: a = 0, b = 1 (copy) during warm-up, then
    (beta, 1 - beta) every `ema_update_every` steps, else (1, 0).

Each stage is one in-place `torch._foreach_*_` call over a chunk of
leaves (`CHUNK_ELEMENTS` elements), so on the card the update is a few
multi-tensor launches a chunk, and its temporaries are one chunk's. With
`donate` it writes over the state it is given, as a jitted JAX step
donates its buffers: a model whose float32 masters, moments and EMA fill
most of the card needs no second copy of them; without, it first copies
each chunk's params, moments and EMA and leaves the given state as it
was. The step counters are host integers (no device sync).
"""

from __future__ import annotations

import torch

from transfusion_tpu_torch.training.optim import _bias_correction, global_norm

CHUNK_ELEMENTS = 1 << 26  # a chunk's temporaries: a few x 256 MiB of float32


def chunks(keys: list, params: dict, size: int) -> list:
    """keys in order, cut into runs of at most `size` elements (a larger
    leaf alone)."""
    out, run, n = [], [], 0
    for k in keys:
        m = params[k].numel()
        if run and n + m > size:
            out.append(run)
            run, n = [], 0
        run.append(k)
        n += m
    return out + [run] if run else out


def _scaled(xs: list, c: float, donate: bool) -> list:
    """xs * c, written over xs when donated, else new tensors."""
    if donate:
        torch._foreach_mul_(xs, c)
        return xs
    return torch._foreach_mul(xs, c)


def fused_clip_adam_ema(grads: dict, params: dict, adam: dict, ema_params: dict,
                        ema_step: int, *, learning_rate: float, grad_clip_norm,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        ema_beta: float = 0.99, ema_update_every: int = 10,
                        ema_update_after_step: int = 100, donate: bool = False):
    """`adam` is the state of `training.optim.adam` ({"count", "mu",
    "nu"}). Returns (new params, new adam state, new ema_params,
    grad_norm), with `donate` the given tensors overwritten; every dict has
    params' keys, and grads must hold one tensor per key (the clip
    overwrites them). The clip's norm is `global_norm`'s (inside
    `optim.sharded`: over every shard of a mesh)."""
    keys = list(params)
    new = ({}, {}, {}, {})  # params, mu, nu, EMA
    g_norm = global_norm(grads)
    if grad_clip_norm is not None:
        # select(norm < c, g, (g / norm) * c): dividing by 1 and multiplying
        # by 1 below the threshold leaves g exact
        trigger = g_norm < grad_clip_norm
        denom = torch.where(trigger, torch.ones_like(g_norm), g_norm)
        mul = torch.where(trigger, torch.ones_like(g_norm),
                          torch.full_like(g_norm, grad_clip_norm))

    count = adam["count"] + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    step = ema_step + 1
    if step <= ema_update_after_step:
        a, b = 0.0, 1.0
    elif step % ema_update_every == 0:
        a, b = ema_beta, 1.0 - ema_beta
    else:
        a, b = 1.0, 0.0

    for run in chunks(keys, params, CHUNK_ELEMENTS):
        g = [grads[k] for k in run]
        p, mu, nu, e = ([d[k] for k in run] for d in (params, adam["mu"], adam["nu"], ema_params))
        if grad_clip_norm is not None:
            torch._foreach_div_(g, denom)
            torch._foreach_mul_(g, mul)
        # mu b1 + g (1 - b1) and nu b2 + g^2 (1 - b2), in the order of the
        # optax sums (whose addends commute exactly); a state not donated
        # takes its new tensors from the first product
        mu, nu = _scaled(mu, b1, donate), _scaled(nu, b2, donate)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_add_(nu, sq)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -learning_rate)
        if donate:
            torch._foreach_add_(p, upd)
        else:
            p = torch._foreach_add(p, upd)
        del sq, den, upd
        e = _scaled(e, a, donate)
        torch._foreach_add_(e, torch._foreach_mul(p, b))
        for out, xs in zip(new, (p, mu, nu, e)):
            out.update(zip(run, xs))

    return new[0], {"count": count, "mu": new[1], "nu": new[2]}, new[3], g_norm
