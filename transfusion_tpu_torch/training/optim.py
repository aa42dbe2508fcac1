"""Gradient transformations over dicts of tensors (counterpart of
`transfusion_tpu/training/optim.py`, and of the optax 0.2.6 pieces that the
JAX package and its examples use).

A transformation is an (init, update) pair: `init(params) -> state` and
`update(updates, state, params) -> (updates, state)`, where params and
updates are dicts of tensors keyed by parameter name (the core's state-dict
names) and a state is a plain tree of dicts, tuples, tensors and Python
ints, so that `torch.save` / `torch.load(weights_only=True)` round-trip it.
Step counters are host ints: no call reads the card back.

  * `chain`, `clip_by_global_norm`, `adam`, `multi_transform`,
    `MultiSteps`, `apply_updates`, `global_norm`: optax's semantics (clip's
    select(norm < c, g, g / norm * c); Adam's bias correction at the
    integer count; MultiSteps' running mean of the grads, zero updates
    between the k-th calls);
  * `adam_atan2`: Adam with a * atan2(m_hat, b sqrt(v_hat)) as the
    direction (no eps);
  * `muon`: Nesterov momentum, then the quintic Newton-Schulz iteration
    (in bf16) orthogonalizes each matrix's update;
  * `muon_param_mask` / `muon_adam_atan2`: Muon on the attention V / out and
    feedforward in / out weights, Adam-atan2 on the rest.

A 2-D parameter here is an `nn.Linear` weight [out, in], the transpose of
the flax kernel [in, out]: Muon's Newton-Schulz result is the transpose of
the JAX one, and its scale max(1, in / out) ** 0.5 reads the flax
orientation.

On a mesh that shards parameters ('fsdp' or 'tensor' > 1) the dicts a
transformation sees are this rank's shards. Inside `sharded(specs, axes)`
(the Trainer opens it around its update) each transformation computes what
it computes on whole tensors, as the JAX chain does under GSPMD: the
elementwise ones (Adam, Adam-atan2, MultiSteps, Muon's momentum,
`apply_updates`) run on the shards unchanged, `global_norm` sums every
shard's squared norm over the mesh, and Muon orthogonalizes each whole
matrix (every rank gathers it, runs the same Newton-Schulz and keeps its
own part). A transformation written by the caller sees the shards as they
are.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, NamedTuple

import torch

from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.mesh import shard_tensor, unshard_tensor

# (specs, axes) of the shards that the transformations are handed, inside
# `sharded`
_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("sharded_layout", default=None)


class GradientTransformation(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple]


@contextlib.contextmanager
def sharded(specs: dict, axes: dict):
    """While open, the dicts handed to the transformations hold this rank's
    shards: `specs` maps a parameter name to the mesh axis of each dim
    (`parallel.mesh.shard_params`), `axes` an axis name to its `comm.Axis`.
    Every rank of the mesh makes the same calls inside it (they hold
    collectives)."""
    token = _LAYOUT.set((specs, axes))
    try:
        yield
    finally:
        _LAYOUT.reset(token)


def global_norm(tree: dict):
    """The L2 norm over every tensor of a dict (the norm of the per-leaf
    norms), a 0-d tensor. Inside `sharded`: the norm of the whole tensors,
    each shard's squared norm divided by the number of ranks that hold the
    same shard, summed over 'tensor' and 'fsdp'."""
    norms = torch.stack(torch._foreach_norm(list(tree.values())))
    layout = _LAYOUT.get()
    if layout is None:
        return torch.linalg.vector_norm(norms)
    specs, axes = layout
    copies = [1] * len(tree)
    for i, k in enumerate(tree):
        for a in ("fsdp", "tensor"):
            if a not in specs[k]:
                copies[i] *= axes[a].size
    sq = (norms.float().square() / torch.tensor(copies, dtype=torch.float32,
                                                device=norms.device)).sum()
    for a in ("tensor", "fsdp"):
        sq = comm.all_reduce_sum(sq, axes[a])
    return sq.sqrt()


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, in each parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def _lr(learning_rate, count: int) -> float:
    """Adam's step size for the update that follows `count` earlier ones: a
    constant, or a schedule of the count (optax's scale_by_schedule).
    adam_atan2 and muon take a constant, as their JAX versions do."""
    return float(learning_rate(count)) if callable(learning_rate) else float(learning_rate)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in float32, as optax computes it."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


def chain(*transforms) -> GradientTransformation:
    """Apply `transforms` in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """g / norm * max_norm when the global norm (`global_norm`) reaches
    max_norm."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return {k: torch.where(trigger, g, g / g_norm.to(g.dtype) * max_norm)
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def _moments(updates, state, b1, b2):
    mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in updates.items()}
    nu = {k: (1 - b2) * g * g + b2 * state["nu"][k] for k, g in updates.items()}
    return mu, nu


def _init_moments(params):
    return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: -lr * mu_hat / (sqrt(nu_hat) + eps)."""

    def update(updates, state, params=None):
        mu, nu = _moments(updates, state, b1, b2)
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        lr = _lr(learning_rate, state["count"])
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) * -lr for k in mu}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(_init_moments, update)


def adam_atan2(learning_rate, b1: float = 0.9, b2: float = 0.99, a: float = 1.27,
               b: float = 1.0, weight_decay: float = 0.0) -> GradientTransformation:
    """Adam with a * atan2(m_hat, b * sqrt(v_hat)) in place of
    m_hat / (sqrt(v_hat) + eps) (Everett et al. 2024)."""

    def update(updates, state, params=None):
        mu, nu = _moments(updates, state, b1, b2)
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {k: a * torch.atan2(mu[k] / c1, b * torch.sqrt(nu[k] / c2)) for k in mu}
        if weight_decay > 0 and params is not None:
            out = {k: u + weight_decay * params[k] for k, u in out.items()}
        return ({k: u * -learning_rate for k, u in out.items()},
                {"count": count, "mu": mu, "nu": nu})

    return GradientTransformation(_init_moments, update)


def _newton_schulz(g, steps: int = 5, eps: float = 1e-7):
    """Orthogonalize a 2-D matrix by the quintic Newton-Schulz iteration,
    in bf16, on its wide orientation."""
    a_c, b_c, c_c = 3.4445, -4.7750, 2.0315
    x = g.to(torch.bfloat16)
    transpose = g.shape[0] > g.shape[1]
    if transpose:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    for _ in range(steps):
        A = x @ x.T
        B = b_c * A + c_c * A @ A
        x = a_c * x + B @ x
    if transpose:
        x = x.T
    return x.to(g.dtype)


def _orth_whole(u, ns_steps: int):
    return _newton_schulz(u, ns_steps) * max(1.0, u.shape[1] / u.shape[0]) ** 0.5


def muon(learning_rate, momentum: float = 0.95, nesterov: bool = True,
         ns_steps: int = 5) -> GradientTransformation:
    """Momentum, orthogonalized per matrix (other shapes pass through),
    scaled by max(1, in / out) ** 0.5 of the flax kernel [in, out]. Inside
    `sharded`, each matrix is rebuilt whole from its shards
    (`unshard_tensor`, which keeps the fused matrices' halves in order),
    orthogonalized and scaled by its whole shape, and cut back to this
    rank's shard."""

    def init(params):
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def orth(name, u):
        if u.ndim != 2:
            return u
        layout = _LAYOUT.get()
        if layout is None:
            return _orth_whole(u, ns_steps)
        specs, axes = layout
        whole = unshard_tensor(name, u, specs[name], axes)
        return shard_tensor(name, _orth_whole(whole, ns_steps), specs[name], axes)

    def update(updates, state, params=None):
        mu = {k: momentum * state["mu"][k] + g for k, g in updates.items()}
        use = {k: g + momentum * mu[k] for k, g in updates.items()} if nesterov else mu
        return {k: orth(k, u) * -learning_rate for k, u in use.items()}, {"mu": mu}

    return GradientTransformation(init, update)


def multi_transform(transforms: dict,
                    param_labels: Callable[[dict], dict]) -> GradientTransformation:
    """Each transform of `transforms` (label -> transformation) on the
    parameters to which `param_labels(params)` (name -> label) gives its
    label; the state is label -> its state."""

    def labels_of(params):
        labels = param_labels(params)
        unknown = set(labels.values()) - set(transforms)
        if unknown:
            raise ValueError(f"multi_transform: labels {sorted(unknown)} have no transform")
        return labels

    def part(tree, labels, label):
        return {k: v for k, v in tree.items() if labels[k] == label}

    def init(params):
        labels = labels_of(params)
        return {lb: t.init(part(params, labels, lb)) for lb, t in transforms.items()}

    def update(updates, state, params=None):
        labels = labels_of(updates if params is None else params)
        out, new_state = {}, {}
        for lb, t in transforms.items():
            sub_params = None if params is None else part(params, labels, lb)
            sub, new_state[lb] = t.update(part(updates, labels, lb), state[lb], sub_params)
            out.update(sub)
        return {k: out[k] for k in updates}, new_state

    return GradientTransformation(init, update)


class MultiSteps:
    """optax.MultiSteps: keep the running mean of the grads over
    `every_k_schedule` calls, return zero updates on the calls between, and
    on the k-th hand the mean to `opt` and return its update."""

    def __init__(self, opt, every_k_schedule: int):
        self.opt, self.k = opt, every_k_schedule

    def init(self, params):
        return {"mini_step": 0, "gradient_step": 0, "inner_opt_state": self.opt.init(params),
                "acc_grads": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, updates, state, params=None):
        n = state["mini_step"]
        # Welford's running mean, as optax takes it
        acc = {k: a + (updates[k] - a) / (n + 1) for k, a in state["acc_grads"].items()}
        if n != self.k - 1:
            return ({k: torch.zeros_like(g) for k, g in updates.items()},
                    {**state, "mini_step": n + 1, "acc_grads": acc})
        out, inner = self.opt.update(acc, state["inner_opt_state"], params)
        return out, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                     "inner_opt_state": inner,
                     "acc_grads": {k: torch.zeros_like(a) for k, a in acc.items()}}


MUON_SITES = ("to_v", "to_out", "proj_in", "proj_out")


def muon_param_mask(params: dict) -> dict:
    """name -> True for the matrices Muon takes: a 2-D weight whose name
    holds one of MUON_SITES. The JAX mask matches these substrings of the
    flax path, so `to_v` also selects `to_value_residual_mix` there, and
    here."""
    return {k: p.ndim == 2 and k.endswith("weight") and any(s in k for s in MUON_SITES)
            for k, p in params.items()}


def muon_adam_atan2(muon_lr: float = 1e-3, adam_lr: float = 1e-4,
                    weight_decay: float = 0.0) -> GradientTransformation:
    """Muon on the `muon_param_mask` matrices, Adam-atan2 on the rest."""
    return multi_transform(
        {"muon": muon(muon_lr), "adam": adam_atan2(adam_lr, weight_decay=weight_decay)},
        lambda params: {k: "muon" if m else "adam" for k, m in muon_param_mask(params).items()})
