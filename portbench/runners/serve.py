"""The serving cells (traffic kind `serve_open_loop`).

Set-up builds the port's `ServingEngine` over the architecture's model,
on weights made on the device from the seed, runs its `warmup()` and one
request of each prefill width the traffic's prompts take, and starts the
arrivals `ramp_s` seconds before the window, so that the window opens on
a loaded engine. One host thread drives the engine: it submits each
request when it falls due and otherwise calls `engine.step()` (admission
and prefill of the queued requests, then one decode chunk); when nothing
is running it sleeps until the next arrival. Arrivals go on after the window until every request due
in it has finished, or `drain_s` seconds have passed (then the rest count
as failed).

A request is timed from when it was due: its first token when the host
holds it (the end of its first chunk), its last token likewise. The end-
to-end metrics are over the requests due in the window, and the tokens
the host received in it.

After the run the program is freed, and the plain reference
(`reference/serve_check.py`) reads a sample of the finished requests.

With `trace` a few seconds in the middle of the window run under the
profiler (a synchronise at each end); the host-clock metrics come from
the window's other ticks.

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
from portbench.generators.serve_open_loop import requests as make_requests
from portbench.generators.train_packed import rng_for
from portbench.reference import serve_check

TRACE_S = 4.0
WINDOW = 1  # the stretch of the traffic that is the window: after the ramp


class TickRows:
    """The engine's tick rows (its `metrics=` logger), kept in memory with
    the host time each was logged at."""

    def __init__(self):
        self.rows = []

    def log(self, step, metrics, tokens=None):
        self.rows.append(dict(metrics, tick=step, t=time.perf_counter()))


def _bucket(n: int, cap: int) -> int:
    """The engine's prefill width of an n-token prompt (a power-of-two
    multiple of 128, at most the capacity)."""
    chunks = -(-max(n, 1) // 128)
    return min(128 * (1 << (chunks - 1).bit_length()), cap)


def warm(engine, cfg: dict, reqs: list):
    """One request through each prefill width the traffic takes."""
    cap = engine.cap
    for width in sorted({_bucket(len(r[1]), cap) for r in reqs}):
        n = min(width, cap - 2)
        engine.submit(np.full(n, 7, np.int32), 2)
        while engine.has_work:
            engine.step()


def drive(engine, reqs: list, t0: float, w0: float, w1: float, drain_s: float,
          trace_at: float | None = None, sync=None):
    """Serve `reqs` [(due, prompt, budget, stretch)] on the schedule
    starting at host time t0; the window [w0, w1) is stretch 1. Returns a
    record: per request its due, submit, first and last token times and
    its tokens; the ticks with their host spans and the work each did; and,
    with `trace_at`, the profiler run over [trace_at, trace_at + TRACE_S)."""
    recs = [{"due": t0 + d, "prompt": p, "budget": b, "sub": None, "first": None,
             "last": None, "tokens": None, "stretch": s} for d, p, b, s in reqs]
    by_rid, i_next, ticks = {}, 0, []
    prof, prof_span = None, None
    due_in_window = [r for r in recs if r["stretch"] == WINDOW]
    deadline = w1 + drain_s
    while True:
        now = time.perf_counter()
        while i_next < len(recs) and recs[i_next]["due"] <= now:
            r = recs[i_next]
            by_rid[engine.submit(r["prompt"], r["budget"])] = r
            r["sub"] = time.perf_counter()
            i_next += 1
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
        if now >= w1 and all(r["last"] is not None for r in due_in_window):
            break
        if now >= deadline:
            break
        if not engine.has_work:
            if i_next < len(recs):
                time.sleep(max(0.0, min(recs[i_next]["due"] - time.perf_counter(), 0.05)))
                continue
            break
        before = {id(r): len(r.tokens) for r in engine.slots if r is not None}
        queued = {id(r) for r in engine.queue}
        ta = time.perf_counter()
        with span("engine_step"):
            finished = engine.step()
        tb = time.perf_counter()
        work = {"admitted": [], "decoded": []}
        for r in [r for r in engine.slots if r is not None] + finished:
            rec = by_rid[r.rid]
            e0 = before.get(id(r), 0)
            if id(r) in queued:
                work["admitted"].append(len(rec["prompt"]))
            if len(r.tokens) > e0:
                work["decoded"].append((len(rec["prompt"]), e0, len(r.tokens)))
                if rec["first"] is None:
                    rec["first"] = tb
        for r in finished:
            rec = by_rid[r.rid]
            rec["last"], rec["tokens"] = tb, list(r.tokens)
        ticks.append({"t0": ta, "t1": tb, "work": work,
                      "row": engine.metrics.rows[-1] if engine.metrics.rows else None})
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
        prof_span[1] = time.perf_counter()
        prof_done = prof
    return {"recs": recs, "ticks": ticks, "due_in_window": due_in_window,
            "prof": prof_done if prof_span else None, "prof_span": prof_span,
            "late": [r["sub"] - r["due"] for r in recs if r["sub"] is not None]}


def summarize(rec: dict, w0: float, w1: float) -> dict:
    """The end-to-end numbers of a driven run over the window [w0, w1)."""
    due = rec["due_in_window"]
    done = [r for r in due if r["last"] is not None]
    ttft = [(r["first"] - r["due"]) * 1e3 for r in done]
    lat = [r["last"] - r["due"] for r in done]
    tokens = sum(sum(n1 - n0 for _, n0, n1 in t["work"]["decoded"]) for t in rec["ticks"]
                 if w0 <= t["t1"] < w1)
    return {"due": len(due), "done": len(done), "tokens_in_window": tokens,
            "serve_tokens_per_s": tokens / (w1 - w0),
            "ttft_p90_ms": percentile(ttft, 90) if ttft else None,
            "latency_p90_s": percentile(lat, 90) if lat else None,
            "ttft_p50_ms": percentile(ttft, 50) if ttft else None,
            "latency_p50_s": percentile(lat, 50) if lat else None,
            "late_max_s": max(rec["late"]) if rec["late"] else 0.0}


def build_engine(arch, cell: dict, cfg: dict, seed: int, device):
    from transfusion_tpu_torch.models.engine import ServingEngine

    model = arch.build_model(cfg, cell, device)
    W = weights.make(arch, cfg, seed, device, getattr(torch, cfg["dtype"]))
    arch.load_weights(model, W)
    del W
    return ServingEngine(model, **cell["engine"], metrics=TickRows())


def run(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", check: bool = True, rate: float | None = None, after=None,
        started: float | None = None):
    """One run of a serving cell of the architecture `arch`: (result
    without checks, checks).
    `after(sample)`, when given, is called with the checked sample once
    the program is freed (the control's readings). `started`: the
    `time.perf_counter()` at which set-up began (default: now)."""
    started = time.perf_counter() if started is None else started
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    engine = build_engine(arch, cell, cfg, seed, device)
    ramp, drain = traffic["ramp_s"], traffic["drain_s"]
    reqs = make_requests(traffic, seed, [ramp, seconds, drain], cfg["num_text_tokens"], rate)
    warm(engine, cfg, reqs)  # first, so that lazy first calls stay out of warmup's timings
    if cuda:
        engine.warmup(fit_cap_slope=False)
    print(f"portbench: the engine's cost model: {engine.cost_fit}, rtt "
          f"{engine._rtt_est!r} s, step {engine._step_est!r} s", file=sys.stderr)
    engine.metrics.rows.clear()
    sync()
    t0 = time.perf_counter()
    w0, w1 = t0 + ramp, t0 + ramp + seconds
    trace_at = 0.5 * (w0 + w1) - 0.5 * TRACE_S if trace else None
    rec = drive(engine, reqs, t0, w0, w1, drain, trace_at, sync)
    setup_s = w0 - started
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = summarize(rec, w0, w1)
    print(f"portbench: {stats['due']} requests due in the window, {stats['done']} finished; "
          f"generator lateness max {stats['late_max_s']:.6f} s", file=sys.stderr)

    result = {"attempted": stats["due"], "failed": stats["due"] - stats["done"]}
    if trace:
        result["layer_ctx"] = _trace_ctx(rec, w0, w1, arch, cfg, cell, traffic, peak)
    else:
        result["metrics"] = {
            "serve_tokens_per_s": {"value": stats["serve_tokens_per_s"], "unit": "tokens/s"},
            "ttft_p90_ms": {"value": stats["ttft_p90_ms"], "unit": "ms"},
            "latency_p90_s": {"value": stats["latency_p90_s"], "unit": "s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["device"] = device_info(torch, 1, peak) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    served = [(r["prompt"], r["tokens"]) for r in rec["due_in_window"] if r["tokens"]]
    del engine, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    sample = sample_requests(served, seed, traffic["sample"])
    if after is not None:
        after(sample)
    if check:
        gap = serve_check.widest_gap(arch, cfg, seed, device, sample)
        checks = {"logit_gap": {"value": gap, "limit": cell["limits"]["logit_gap"]},
                  "unfinished": {"value": stats["due"] - stats["done"], "limit": 0}}
    return result, checks


def sample_requests(served: list, seed: int, k: int) -> list:
    """k of the finished requests, drawn from the seed, the one with the
    most served tokens always among them."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i][1]))
    rest = [i for i in range(len(served)) if i != longest]
    picked = rng_for(seed, 3).permutation(rest)[:max(k - 1, 0)].tolist()
    return [served[i] for i in [longest, *picked]]


def _trace_ctx(rec, w0, w1, arch, cfg, cell, traffic, peak) -> dict:
    dev, host = trace_events(rec["prof"])
    lo = min(s for _, s, _ in host + dev)
    hi = max(e for _, _, e in host + dev)
    p0, p1 = rec["prof_span"]
    inside = [t for t in rec["ticks"] if p0 <= t["t0"] and t["t1"] <= p1]
    outside = [t for t in rec["ticks"] if w0 <= t["t0"] and t["t1"] < w1
               and not (t["t1"] > p0 and t["t0"] < p1)]
    # requests of the window that neither waited nor decoded under the profiler
    clear = [(r["first"] - r["due"]) * 1e3 for r in rec["due_in_window"]
             if r["last"] is not None and (r["last"] <= p0 or r["due"] >= p1)]
    return {"kind": "serve", "arch": arch, "cfg": cfg, "traffic": traffic, "cell": cell,
            "ttft_ms_outside": clear,
            "device_ops": dev, "host_ops": host, "trace_lo": lo, "trace_hi": hi,
            "busy_s": union_seconds(dev, lo, hi), "trace_window_s": hi - lo,
            "traced_ticks": inside, "outside_ticks": outside,
            "outside_s": (w1 - w0) - (p1 - p0), "max_batch": cell["engine"]["max_batch"],
            "peak_bytes": peak, "breakdown": breakdown(dev, host, lo, hi)}


def readings(arch, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             with_control: bool) -> dict:
    """The readings that set the cell's limit (`control.py`), on the card:
    a short window at the cell's load, and the same sample as a benchmark
    run read by the float32 reference against the program's tokens and,
    with `with_control`, against the control's (the reference in fp8)."""
    from portbench.reference import quant

    out = {"seed": seed}

    def after(sample):
        out["served_tokens"] = sum(len(t) for _, t in sample)
        out["program"] = {"logit_gap": serve_check.widest_gap(arch, cfg, seed, "cuda", sample)}
        if with_control:
            out["control"] = {"logit_gap": serve_check.widest_gap(arch, cfg, seed, "cuda",
                                                                  sample, quant=quant.fp8)}

    run(arch, cell, cfg, traffic, seed, seconds, False, check=False, after=after)
    return out
