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

Each stage is one `torch._foreach_*` call over all leaves, so on the card
the update is a few multi-tensor launches rather than one per leaf and op.
The step counters are host integers (no device sync).
"""

from __future__ import annotations

import torch

from transfusion_tpu_torch.training.optim import _bias_correction, global_norm


def fused_clip_adam_ema(grads: dict, params: dict, adam: dict, ema_params: dict,
                        ema_step: int, *, learning_rate: float, grad_clip_norm,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        ema_beta: float = 0.99, ema_update_every: int = 10,
                        ema_update_after_step: int = 100, norm_fn=None):
    """`adam` is the state of `training.optim.adam` ({"count", "mu",
    "nu"}). Returns (new_params, new adam state, new_ema_params,
    grad_norm); every dict has params' keys, and grads must hold one tensor
    per key. `norm_fn` (default `global_norm`) computes the clip's norm: on
    a mesh's shards, one that sums over every shard."""
    keys = list(params)
    g = [grads[k] for k in keys]
    p = [params[k] for k in keys]
    mu = [adam["mu"][k] for k in keys]
    nu = [adam["nu"][k] for k in keys]
    e = [ema_params[k] for k in keys]

    g_norm = (norm_fn or global_norm)(grads)
    if grad_clip_norm is not None:
        # select(norm < c, g, (g / norm) * c): dividing by 1 and multiplying
        # by 1 below the threshold leaves g exact
        trigger = g_norm < grad_clip_norm
        denom = torch.where(trigger, torch.ones_like(g_norm), g_norm)
        mul = torch.where(trigger, torch.ones_like(g_norm),
                          torch.full_like(g_norm, grad_clip_norm))
        g = torch._foreach_mul(torch._foreach_div(g, denom), mul)

    count = adam["count"] + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)

    mu_n = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
    nu_n = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                              torch._foreach_mul(nu, b2))
    mu_hat = torch._foreach_div(mu_n, c1)
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu_n, c2)), eps)
    upd = torch._foreach_mul(torch._foreach_div(mu_hat, den), -learning_rate)
    p_n = torch._foreach_add(p, upd)

    step = ema_step + 1
    if step <= ema_update_after_step:
        a, b = 0.0, 1.0
    elif step % ema_update_every == 0:
        a, b = ema_beta, 1.0 - ema_beta
    else:
        a, b = 1.0, 0.0
    e_n = torch._foreach_add(torch._foreach_mul(e, a), torch._foreach_mul(p_n, b))

    def as_dict(xs):
        return dict(zip(keys, xs))

    return (as_dict(p_n), {"count": count, "mu": as_dict(mu_n), "nu": as_dict(nu_n)},
            as_dict(e_n), g_norm)
