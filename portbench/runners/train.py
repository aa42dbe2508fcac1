"""The training cells (traffic kind `train_packed`).

Set-up builds one `Trainer` with its model (the architecture's) and
state, on weights made on the device from the seed, and a `PackingLoader`
over the seed's rows. It drives that trainer through its first three
steps, on the loader's batches and the benchmark's own draws, reading
what the check compares: each step's loss, the first gradient as the
optimizer got it (Adam's first moment after one step, over 1 - b1) and,
after the third step, each leaf's change. Those steps are also the warm-up: every shape of the cell
has run. The same trainer then runs the window: whole steps, back to back,
until `seconds` have passed, and one synchronise at the end. Tokens are
the packed rows' positions.

After the window the program is freed and the plain reference
(`reference/train_check.py`) follows the three steps on the same rows and
draws, made again from the seed.

With `trace` a few steps in the middle of the window run under the
profiler (a synchronise at each end); the host-clock metrics come from the
window's other steps.

`readings` gives `control.py` the numbers that set the cell's limits.
"""

from __future__ import annotations

import gc
import itertools
import time

import torch

from portbench import weights, work
from portbench.common import breakdown, device_info, profiled, span, trace_events, union_seconds
from portbench.generators.train_packed import Rows, image_head, row_layout, step_rows
from portbench.reference import train_check

CHECK_STEPS = 3
B1 = 0.9  # Adam's first-moment decay in the port's default optimizer
TRACE_STEPS = 2


def modality_times(u_count, u_time, num_mods, m: int):
    """The joint loss's default draw of times [b, m]: a random number
    floor(u_count * images in the row) of a row's first images are pinned
    at 0.5 ('already decoded'), the rest share u_time."""
    rank = torch.arange(m, device=u_count.device)[None, :]
    pinned = rank < torch.floor(u_count * num_mods.to(torch.float32))[:, None]
    return torch.where(pinned, 0.5, u_time[:, None])


class Draws:
    """The loss's random draws, made by the benchmark from the seed and its
    own rows: per microbatch the CFG uniforms and times of its rows and the
    noise of its images in (row, image) order."""

    def __init__(self, seed: int, device, image_shape: tuple):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed((int(seed) * 2 + 1) % (1 << 63))
        self.device, self.image_shape = device, tuple(image_shape)

    def make(self, layouts: list) -> dict:
        """layouts: the microbatch's rows (`row_layout`)."""
        counts = [sum(1 for it in lay if it[0] == "i") for lay in layouts]
        m = max(2, -(-max(counts) // 2) * 2)  # the packer's span rows: even, at least 2
        num_mods = torch.as_tensor(counts, device=self.device)
        u = torch.rand((3, len(counts)), generator=self.gen, device=self.device)
        noise = torch.randn((sum(counts), *self.image_shape), generator=self.gen,
                            device=self.device)
        return {"times": modality_times(u[0], u[1], num_mods, m), "cfg_uniform": u[2],
                "noise": noise}


def program_draws(packed, d: dict):
    """The port's LossDraws of a packed batch from the benchmark's draws of
    its rows: the packed batch's rows take the first rows' draws, and its
    one latent group the first images' noise, in (row, image) order."""
    from transfusion_tpu_torch.models.transfusion import LossDraws

    b, m = packed.spans.shape[:2]
    groups = packed.groups
    if len(groups) > 1:
        raise ValueError("the traffic has one image shape, so one latent group")
    noises = ()
    if groups:
        g = groups[0]
        order = sorted(range(len(g.batch_idx)), key=lambda i: (g.batch_idx[i], g.span_rows[i]))
        if order != list(range(len(order))):
            raise ValueError("the latent group is not in (row, image) order")
        noises = (d["noise"][:len(order)],)
    times = d["times"][:b, :m]
    if times.shape[1] < m:
        times = torch.nn.functional.pad(times, (0, m - times.shape[1]))
    return LossDraws(times=times, cfg_uniform=d["cfg_uniform"][:b], noises=noises)


def run(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", check: bool = True, after=None,
        started: float | None = None) -> tuple[dict, dict]:
    """One run of a training cell of the architecture `arch`: (result
    without checks, checks).
    `after(step_rows, step_draws, program, names)`, when given, is called
    once the program is freed (the control's readings). `started`: the
    `time.perf_counter()` at which set-up began (default: now)."""
    from transfusion_tpu_torch.data.dataloader import PackingLoader
    from transfusion_tpu_torch.training.trainer import Trainer

    started = time.perf_counter() if started is None else started
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    M = traffic["microbatches"]
    rows_per_micro = traffic["rows_per_step"] // M
    n = traffic["row_len"]

    model = arch.build_model(cfg, cell, device)
    W = weights.make(arch, cfg, seed, device, torch.float32)
    arch.load_weights(model, W)
    names = [k for k, _ in model.core.named_parameters()]
    trainer = Trainer(model, **cell.get("trainer", {}),
                      grad_accumulation=M if M > 1 else None)
    state = trainer.init_state(params={k: W[k] for k in names})
    del W
    dataset = Rows(traffic, seed, cfg["num_text_tokens"], cfg["dim_latent"])
    loader = PackingLoader(model, dataset, rows_per_micro, shuffle=False,
                           prefetch=traffic["prefetch"], pad_len=n + 1)
    draws = Draws(seed, device, (*traffic["image_shape"], cfg["dim_latent"]))
    kept_draws = []

    micro = itertools.count()  # the loader's batches, in order

    def next_batch():
        packs, ds = [], []
        for _ in range(M):
            packs.append(next(loader))
            j = next(micro)
            ds.append(draws.make([row_layout(traffic, seed, i) for i in
                                  range(j * rows_per_micro, (j + 1) * rows_per_micro)]))
        pd = [program_draws(p, d) for p, d in zip(packs, ds)]
        return (packs[0], pd[0], ds) if M == 1 else (packs, pd, ds)

    try:
        losses = []
        for s in range(CHECK_STEPS):
            batch, pd, ds = next_batch()
            kept_draws.append(ds)
            state, metrics = trainer.train_step(state, batch, draws=pd)
            losses.append(metrics["loss"].detach().float())
            if s == 0:
                mu = _adam_state(state)["mu"]
                grad_norms = {k: mu[k].float().norm() / (1.0 - B1) for k in names}
        init = weights.make(arch, cfg, seed, device, torch.float32, names=set(names))
        change_norms = {k: (state.params[k] - init[k]).norm() for k in names}
        del init
        sync()
        program = {"loss": [float(x) for x in losses],
                   "grad": {k: float(v) for k, v in grad_norms.items()},
                   "change": {k: float(v) for k, v in change_norms.items()}}
        setup_s = time.perf_counter() - started

        step_tokens = traffic["rows_per_step"] * n
        steps, waits, t_prof = 0, [], None
        prof = None
        t_start = time.perf_counter()
        while True:
            if trace and steps == 1:
                sync()
                t_prof = [time.perf_counter(), None, steps]
                prof = torch.profiler.profile(activities=profiled(cuda))
                prof.__enter__()
            tw = time.perf_counter()
            with span("next_batch"):
                batch, pd, _ = next_batch()
            wait = time.perf_counter() - tw
            with span("train_step"):
                state, metrics = trainer.train_step(state, batch, draws=pd)
            steps += 1
            if prof is not None and steps == 1 + TRACE_STEPS:
                sync()
                prof.__exit__(None, None, None)
                t_prof[1] = time.perf_counter()
                t_prof.append(steps)
                prof_done, prof = prof, None
            elif t_prof is None or t_prof[1] is not None:
                waits.append(wait)
            if time.perf_counter() - t_start >= seconds and (not trace or t_prof is not None
                                                             and t_prof[1] is not None):
                break
        sync()
        window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        loader.close()

    result = {"attempted": steps, "failed": 0}
    if trace:
        result["layer_ctx"] = _trace_ctx(prof_done, t_prof, window_s, steps, waits, arch, cfg,
                                         traffic, seed, cell, peak)
    else:
        result["metrics"] = {
            "train_tokens_per_s": {"value": steps * step_tokens / window_s, "unit": "tokens/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["device"] = device_info(torch, 1, peak) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    del state, trainer, model, loader, metrics, batch, pd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    step_batches = [[dataset[i] for i in step_rows(traffic, s)] for s in range(CHECK_STEPS)]
    if check:
        checks = train_check.check(arch, cfg, cell, traffic, seed, device, step_batches,
                                   kept_draws, program, names)
    if after is not None:
        after(step_batches, kept_draws, program, names)
    return result, checks


def _adam_state(state) -> dict:
    """Adam's {'count', 'mu', 'nu'} in the Trainer's state (after the clip's
    state in the chain)."""
    opt = state.opt_state
    return opt[1] if isinstance(opt, tuple) else opt


def _trace_ctx(prof, t_prof, window_s, steps, waits, arch, cfg, traffic, seed, cell,
               peak) -> dict:
    """What the per-layer readers read of a traced run."""
    dev, host = trace_events(prof)
    lo = min(s for _, s, _ in host + dev)
    hi = max(e for _, _, e in host + dev)
    busy = union_seconds(dev, lo, hi)
    n, image_len = traffic["row_len"], traffic["image_shape"][0] * traffic["image_shape"][1]

    def step_work(s):
        layouts = [row_layout(traffic, seed, i) for i in step_rows(traffic, s)]
        return work.train_step_work({"n": n, "layouts": layouts, "image_len": image_len,
                                     "image_head": image_head(traffic["image_shape"])})

    first, last = CHECK_STEPS + t_prof[2], CHECK_STEPS + t_prof[3]
    traced = [step_work(s) for s in range(first, last)]
    window_steps = range(CHECK_STEPS, CHECK_STEPS + steps)
    outside = [step_work(s) for s in window_steps if not first <= s < last]
    return {"kind": "train", "arch": arch, "cfg": cfg, "traffic": traffic, "cell": cell,
            "device_ops": dev, "host_ops": host, "trace_lo": lo, "trace_hi": hi,
            "busy_s": busy, "trace_window_s": hi - lo, "traced_work": traced,
            "outside_work": outside, "outside_s": window_s - (t_prof[1] - t_prof[0]),
            "loader_waits_s": waits, "peak_bytes": peak,
            "remat": cell.get("model", {}).get("remat", False),
            "breakdown": breakdown(dev, host, lo, hi)}


def readings(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             with_control: bool) -> dict:
    """The readings that set the cell's limits (`control.py`), on the card:
    the program's numbers against the float32 reference and, with
    `with_control`, the control's (the reference in fp8 in the program's
    place), the planted fault of half the batch left out, and the state
    left unchanged."""
    from portbench.reference import quant

    out = {"seed": seed}

    def after(step_rows, step_draws, program, names):
        n, lr = traffic["row_len"] + 1, cell.get("trainer", {}).get("learning_rate", 3e-4)
        args = (arch, cfg, seed, "cuda", step_rows, step_draws, n, names, lr)
        ref = train_check.follow(*args)
        out["program"] = train_check.compare(program, ref, names)
        out["loss"] = {"program": program["loss"], "reference": ref["loss"]}
        if with_control:
            gc.collect()
            torch.cuda.empty_cache()
            out["control"] = train_check.compare(train_check.follow(*args, quant=quant.fp8),
                                                 ref, names)
            gc.collect()
            torch.cuda.empty_cache()
            out["half"] = train_check.compare(train_check.follow(*args, half=True), ref, names)
            out["unchanged"] = train_check.compare(
                {"loss": ref["loss"], "grad": {k: 0.0 for k in names},
                 "change": {k: 0.0 for k in names}}, ref, names)

    run(arch, cell, cfg, traffic, seed, seconds, False, check=False, after=after)
    return out
