"""The image-serving cells (a traffic file's `"runner": "serve_image"`):
text-to-image requests to one replica of the port's
`MultimodalServingEngine`.

Each request is a caption (`caption` ids drawn from the seed, then the
modality's [som]; the engine puts the sos before it); its budget ends it once its one image of
`image_shape` latents is made (max_length one under the image's rows), so
a request is admitted (its caption and its CFG twin prefilled), parked at
its [som], integrated in the engine's grouped ODE (`modality_steps`
midpoint points, classifier-free guidance `cfg_scale`) and retired in the
tick that fetches its latent to the host. Arrivals are open loop, as
`generators/serve_open_loop.py` lays them out: round(rate x length)
requests a stretch (ramp, window, after), gaps the stratified quantiles of
an exponential, caption lengths the stratified quantiles of a uniform over
[min, max], each list permuted by the seed.

Set-up builds the engine over the architecture's model on weights made on
the device from the seed, runs one burst of requests (every caption width)
through it, and starts the arrivals `ramp_s` seconds before the window. A
request is timed from when it was due to the end of the tick that hands
its image to the host; `latency_p90_s` is over the requests due in the
window. After the run the program is freed and the plain reference
(`reference/image_check.py`) integrates a sample of them again.

With `trace` a few seconds in the middle of the window run under the
profiler; the engine's counters give the images a grouped ODE dispatch
integrated over the window (`ode_images`, `ode_dispatches`).

`readings` gives `control.py` the numbers that set the cell's limit.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import weights
from portbench.common import (breakdown, device_info, percentile, profiled, span, trace_events,
                              union_seconds)
from portbench.generators.train_packed import rng_for
from portbench.reference import image_check
from portbench.runners.serve import TRACE_S, WINDOW, TickRows


def requests(traffic: dict, seed: int, stretches: list, som_id: int, rate=None) -> list:
    """[(due seconds from the start, prompt int32 array, stretch)] in order
    of arrival over consecutive stretches of the given lengths; `rate`
    overrides the traffic's (the sweep)."""
    rate = traffic["rate"] if rate is None else rate
    lo, hi = traffic["caption"]["min"], traffic["caption"]["max"]
    out, start = [], 0.0
    for s, length in enumerate(stretches):
        n = max(1, round(rate * length))
        rng = rng_for(seed, 4, s)
        q = (np.arange(n) + 0.5) / n
        lens = rng.permutation(np.round(lo + q * (hi - lo)).astype(np.int64))
        gaps = rng.permutation(-np.log1p(-q))
        gaps *= length / gaps.sum()
        due = start + np.cumsum(gaps) - gaps
        for i in range(n):
            ids = rng.integers(0, traffic["num_text_tokens"], size=int(lens[i]) + 1,
                               dtype=np.int32)
            ids[-1] = som_id
            out.append((float(due[i]), ids, s))
        start += length
    return out


def image_len(traffic: dict) -> int:
    return int(np.prod(traffic["image_shape"]))


def build_engine(arch, cell: dict, cfg: dict, traffic: dict, seed: int, device):
    from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine

    model = arch.build_model(cfg, cell, device)
    W = weights.make(arch, cfg, seed, device, getattr(torch, cfg["dtype"]))
    arch.load_weights(model, W)
    del W
    return MultimodalServingEngine(model, **cell["engine"], seed=seed,
                                   fixed_modality_shape=tuple(traffic["image_shape"]),
                                   return_unprocessed_modalities=True, metrics=TickRows())


def warm(engine, traffic: dict, som_id: int):
    """One burst of a pool's worth of requests over every caption width."""
    lo, hi = traffic["caption"]["min"], traffic["caption"]["max"]
    for n in np.linspace(lo, hi, engine.R).round().astype(int):
        engine.submit(np.asarray([7] * int(n) + [som_id], np.int32),
                      image_len(traffic) - 1)
    while engine.has_work:
        engine.step()


def drive(engine, reqs: list, budget: int, t0: float, w0: float, w1: float, drain_s: float,
          trace_at=None, sync=None) -> dict:
    """Serve `reqs` on the schedule starting at host time t0 (the window
    is [w0, w1)). Returns per request its due, submit and done times and
    its latent; the ticks with their host spans; the engine's counters at
    the window's open and close; and, with `trace_at`, the profiler run over
    [trace_at, trace_at + TRACE_S)."""
    recs = [{"due": t0 + d, "prompt": p, "stretch": s, "sub": None, "done": None, "rid": None,
             "latent": None} for d, p, s in reqs]
    by_rid, i_next, ticks = {}, 0, []
    prof, prof_span, prof_done, stats = None, None, None, {}
    due_in_window = [r for r in recs if r["stretch"] == WINDOW]
    deadline = w1 + drain_s
    while True:
        now = time.perf_counter()
        while i_next < len(recs) and recs[i_next]["due"] <= now:
            r = recs[i_next]
            r["rid"] = engine.submit(r["prompt"], budget)
            by_rid[r["rid"]] = r
            r["sub"] = time.perf_counter()
            i_next += 1
        for edge, at in (("open", w0), ("close", w1)):
            if edge not in stats and now >= at:
                stats[edge] = dict(engine.stats)
        if trace_at is not None and prof is None and prof_span is None and now >= trace_at:
            sync()
            prof = torch.profiler.profile(activities=profiled(True))
            prof.__enter__()
            prof_span = [time.perf_counter(), None]
        elif prof is not None and now >= prof_span[0] + TRACE_S:
            sync()
            prof.__exit__(None, None, None)
            prof_span[1] = time.perf_counter()
            prof_done, prof = prof, None
        if now >= w1 and all(r["done"] is not None for r in due_in_window):
            break
        if now >= deadline:
            break
        if not engine.has_work:
            if i_next < len(recs):
                time.sleep(max(0.0, min(recs[i_next]["due"] - time.perf_counter(), 0.05)))
                continue
            break
        ta = time.perf_counter()
        with span("engine_step"):
            finished = engine.step()
        tb = time.perf_counter()
        for f in finished:
            rec = by_rid[f.rid]
            rec["done"] = tb
            rec["latent"] = next(it[1] for it in f.items if isinstance(it, tuple))
        ticks.append({"t0": ta, "t1": tb, "row": engine.metrics.rows[-1]
                      if engine.metrics.rows else None})
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
        prof_span[1] = time.perf_counter()
        prof_done = prof
    stats.setdefault("open", dict(engine.stats))
    stats.setdefault("close", dict(engine.stats))
    return {"recs": recs, "ticks": ticks, "due_in_window": due_in_window, "stats": stats,
            "prof": prof_done, "prof_span": prof_span,
            "late": [r["sub"] - r["due"] for r in recs if r["sub"] is not None]}


def summarize(rec: dict) -> dict:
    due = rec["due_in_window"]
    done = [r for r in due if r["done"] is not None]
    lat = [r["done"] - r["due"] for r in done]
    return {"due": len(due), "done": len(done),
            "latency_p90_s": percentile(lat, 90) if lat else None,
            "latency_p50_s": percentile(lat, 50) if lat else None,
            "late_max_s": max(rec["late"]) if rec["late"] else 0.0}


def initial_noise(engine, seed: int, rid: int, traffic: dict):
    """The starting noise the engine drew for request `rid`'s one image
    (its draw of (seed, the noise stream, rid, segment 0))."""
    from transfusion_tpu_torch.models.sample_batch import _NOISE_STREAM, _draw_seed

    g = torch.Generator(device=engine.device).manual_seed(
        _draw_seed(seed, _NOISE_STREAM, rid, 0))
    dim = engine.model.modalities[0].dim_latent
    return torch.randn((*traffic["image_shape"], dim), generator=g, device=engine.device)


def sample_requests(rec: dict, seed: int, k: int) -> list:
    """k of the window's finished requests, drawn from the seed."""
    done = [r for r in rec["due_in_window"] if r["latent"] is not None]
    picked = rng_for(seed, 5).permutation(len(done))[:k].tolist()
    return [done[i] for i in picked]


def run(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", check: bool = True, rate=None, after=None,
        started: float | None = None):
    """One run of an image-serving cell: (result without checks, checks).
    `after(sample, engine_seed)` is called with the checked sample once
    the program is freed (the control's readings)."""
    started = time.perf_counter() if started is None else started
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    traffic = dict(traffic, num_text_tokens=cfg["num_text_tokens"])
    engine = build_engine(arch, cell, cfg, traffic, seed, device)
    som_id = engine.model.som_ids[0]
    warm(engine, traffic, som_id)
    engine.metrics.rows.clear()
    ramp, drain = traffic["ramp_s"], traffic["drain_s"]
    reqs = requests(traffic, seed, [ramp, seconds, drain], som_id, rate)
    sync()
    t0 = time.perf_counter()
    w0, w1 = t0 + ramp, t0 + ramp + seconds
    trace_at = 0.5 * (w0 + w1) - 0.5 * TRACE_S if trace else None
    rec = drive(engine, reqs, image_len(traffic) - 1, t0, w0, w1, drain, trace_at, sync)
    setup_s = w0 - started
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = summarize(rec)
    print(f"portbench: {stats['due']} requests due in the window, {stats['done']} finished; "
          f"generator lateness max {stats['late_max_s']:.6f} s", file=sys.stderr)

    result = {"attempted": stats["due"], "failed": stats["due"] - stats["done"]}
    if trace:
        result["layer_ctx"] = _trace_ctx(rec, w0, w1, arch, cfg, cell, traffic, peak)
    else:
        result["metrics"] = {"latency_p90_s": {"value": stats["latency_p90_s"], "unit": "s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = device_info(torch, 1, peak) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    sample = [dict(r, noise=initial_noise(engine, seed, r["rid"], traffic))
              for r in sample_requests(rec, seed, traffic["sample"])]
    del engine, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    if after is not None:
        after(sample, seed)
    if check:
        gap = image_check.widest_gap(arch, cfg, cell, traffic, seed, device, sample)
        checks = {"image_gap": {"value": gap, "limit": cell["limits"]["image_gap"]},
                  "unfinished": {"value": stats["due"] - stats["done"], "limit": 0}}
    return result, checks


def _trace_ctx(rec, w0, w1, arch, cfg, cell, traffic, peak) -> dict:
    dev, host = trace_events(rec["prof"])
    lo = min(s for _, s, _ in host + dev)
    hi = max(e for _, _, e in host + dev)
    opened, closed = rec["stats"]["open"], rec["stats"]["close"]
    return {"kind": "serve", "arch": arch, "cfg": cfg, "traffic": traffic, "cell": cell,
            "device_ops": dev, "host_ops": host, "trace_lo": lo, "trace_hi": hi,
            "busy_s": union_seconds(dev, lo, hi), "trace_window_s": hi - lo,
            "ode_images": (closed["modality_tokens"] - opened["modality_tokens"])
            / image_len(traffic),
            "ode_dispatches": closed["ode_dispatches"] - opened["ode_dispatches"],
            "peak_bytes": peak, "breakdown": breakdown(dev, host, lo, hi)}


def readings(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             with_control: bool) -> dict:
    """The readings that set the cell's limit (`control.py`), on the card:
    a short window at the cell's load; the sample's widest gap of the
    program and, with `with_control`, of the control (the reference in
    fp8) and of the planted fault (each served latent's first quarter of
    rows zeroed where the host fetches it, `image_check.altered`)."""
    from portbench.reference import quant

    out = {"seed": seed}
    full = dict(traffic, num_text_tokens=cfg["num_text_tokens"])

    def after(sample, engine_seed):
        args = (arch, cfg, cell, full, seed, "cuda", sample)
        out["program"] = {"image_gap": image_check.widest_gap(*args)}
        if with_control:
            out["control"] = {"image_gap": image_check.widest_gap(*args, quant=quant.fp8)}
            altered = [dict(r, latent=image_check.altered(r["latent"])) for r in sample]
            out["altered"] = {"image_gap": image_check.widest_gap(*args[:-1], altered)}

    run(arch, cell, cfg, traffic, seed, seconds, False, check=False, after=after)
    return out
