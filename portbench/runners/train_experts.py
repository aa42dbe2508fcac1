"""The training cells of an expert layer's block (a traffic file's
`"runner": "train_experts"`): `runners/train.py`'s run, whose checks it
keeps, with the routing's checks beside them and the expert layers'
counters for the readers.

The program's model is watched through hooks (`Watch`): the routers'
choices at the first step, and snapshots of each expert layer's device
counter of (token, held expert) assignments (`MoE.expert_load`) at the
step boundaries the check and the traced window need, read after the run.
The reference's choices come from `reference.ROUTES` while the check
follows the three steps. The numbers compared, each with the cell's limit:

* route_gap: the share of the first step's (token, routed layer,
  choice) triples of the program that the reference does not choose;
* load_gap: the program's counters after the three checked steps against
  the reference's counts of the same assignments, sum |program -
  reference| over the sum of the reference's.

A traced run's context gains `moe_traced_counts` (each layer's held
experts' assignments over the profiled steps) and `moe_window_counts`
(over the window's steps).
"""

from __future__ import annotations

import torch

from portbench.runners import train

ROUTING = ("route_gap", "load_gap")


class Watch:
    """Hooks on a built model: the routers' first choices, the counters'
    snapshots before the core calls `marks` (one core call a microbatch)
    and, with `bias_ignored`, the planted fault of routers that choose by
    their scores alone (their selection biases zeroed before each call)."""

    def __init__(self, marks: set, bias_ignored: bool = False):
        self.marks, self.calls, self.snaps = marks, 0, {}
        self.first, self.loads = [], []
        self.bias_ignored = bias_ignored

    def attach(self, model):
        moes = [b.mlp for b in model.core.transformer.blocks if hasattr(b.mlp, "expert_load")]
        self.loads = [m.expert_load for m in moes]
        self.first = [None] * len(moes)
        model.core.register_forward_pre_hook(self._call)
        for i, m in enumerate(moes):
            m.gate.register_forward_hook(lambda mod, args, out, i=i: self._choices(i, out))
            if self.bias_ignored:
                m.gate.register_forward_pre_hook(_zero_bias)

    def _call(self, module, args):
        if self.calls in self.marks:
            self.snaps[self.calls] = torch.stack(self.loads).clone()
        self.calls += 1

    def _choices(self, i, out):
        if self.first[i] is None:
            self.first[i] = out[0].detach().clone()

    def counts(self, at=None) -> torch.Tensor:
        """[layers, held] assignments counted before core call `at` (None,
        or a call that never came: now)."""
        if at is None or at >= self.calls:
            return torch.stack(self.loads)
        return self.snaps[at]


def _zero_bias(router, args):
    router.e_score_correction_bias.zero_()


class Watched:
    """The architecture, its `build_model` attaching the watch."""

    def __init__(self, arch, watch: Watch):
        self._arch, self._watch = arch, watch

    def __getattr__(self, name):
        return getattr(self._arch, name)

    def build_model(self, cfg, cell, device):
        model = self._arch.build_model(cfg, cell, device)
        self._watch.attach(model)
        return model


def route_gap(program: list, reference: list) -> float:
    """The share of the program's (token, layer, choice) triples the
    reference does not choose; each a list of Int64[T, k] a layer."""
    missed = total = 0
    for a, b in zip(program, reference):
        a, b = a.to(b.device), b
        if a.shape != b.shape:
            raise ValueError(f"routing of {tuple(a.shape)} tokens against {tuple(b.shape)}")
        missed += int((~(a[:, :, None] == b[:, None, :]).any(-1)).sum())
        total += a.numel()
    return missed / total


def reference_counts(steps: list, held: int) -> torch.Tensor:
    """[layers, held] of the reference's held assignments over its steps
    (each a list of Int64[T, k] a layer)."""
    return sum(torch.stack([torch.bincount(c[c < held], minlength=held)[:held] for c in step])
               for step in steps)


def load_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    program = program.to(reference.device)
    return float((program - reference).abs().sum()) / float(reference.sum())


def run(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", check: bool = True, after=None, started: float | None = None,
        bias_ignored: bool = False) -> tuple[dict, dict]:
    """`train.run` with the routing's checks (see the module docstring);
    `bias_ignored` plants the fault of `Watch`."""
    M = traffic["microbatches"]
    window0 = train.CHECK_STEPS * M  # the first window step's first core call
    traced = ((train.CHECK_STEPS + 1) * M, (train.CHECK_STEPS + 1 + train.TRACE_STEPS) * M)
    watch = Watch({window0, *traced}, bias_ignored)
    base = dict(cell, limits={k: v for k, v in cell["limits"].items() if k not in ROUTING})
    ref = arch.reference
    ref.ROUTES = [] if check else None
    held = cfg["n_routed_experts"]
    extra = {}

    def checked(step_rows, step_draws, program, names):
        if check:
            routes = ref.ROUTES[:train.CHECK_STEPS]
            gaps = {"route_gap": route_gap(watch.first, routes[0]),
                    "load_gap": load_gap(watch.counts(window0), reference_counts(routes, held))}
            extra.update({k: {"value": v, "limit": cell["limits"][k]} for k, v in gaps.items()
                          if k in cell["limits"]})
        if after is not None:
            after(step_rows, step_draws, program, names)

    try:
        result, checks = train.run(Watched(arch, watch), base, cfg, traffic, seed, seconds, trace,
                                   device=device, check=check, after=checked, started=started)
    finally:
        ref.ROUTES = None
    if trace:
        ctx = result["layer_ctx"]
        ctx["moe_traced_counts"] = (watch.counts(traced[1]) - watch.counts(traced[0])).tolist()
        ctx["moe_window_counts"] = (watch.counts() - watch.counts(window0)).tolist()
    return result, {**checks, **extra}


def readings(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             with_control: bool) -> dict:
    """`train.readings` with the routing's numbers of the program and,
    with `with_control`, of the control (the reference in fp8 routes where
    the program would) and of the planted fault of the selection bias
    ignored (the program's routers choose by their scores alone)."""
    M = traffic["microbatches"]
    watch = Watch({train.CHECK_STEPS * M})
    held, ref = cfg["n_routed_experts"], arch.reference
    ref.ROUTES = []
    try:
        out = train.readings(Watched(arch, watch), dict(cell, limits={}), cfg, traffic, seed,
                             seconds, with_control)
        routes = ref.ROUTES
    finally:
        ref.ROUTES = None
    steps = train.CHECK_STEPS
    base = routes[:steps]  # the reference's follow comes first, then the control's
    out["program"].update(route_gap=route_gap(watch.first, base[0]), load_gap=load_gap(
        watch.counts(steps * M), reference_counts(base, held)))
    if with_control:
        control = routes[steps:2 * steps]
        out["control"].update(route_gap=route_gap(control[0], base[0]), load_gap=load_gap(
            reference_counts(control, held), reference_counts(base, held)))
        _, checks = run(arch, cell, cfg, traffic, seed, seconds, False, bias_ignored=True)
        out["bias_ignored"] = {k: v["value"] for k, v in checks.items()}
    return out
