"""PyTorch port: the continuous-batching text engine
(`models/engine.py`) against the JAX package's `ServingEngine` with the
same weights, and against the port's own solo `generate_text_only`, float32
on the CPU, following tests/test_engine.py.

Greedy tokens must be equal. Above temperature 0 the port's draws come from
streams of its own (seeded from (seed, request id, count), not JAX's
fold-in keys), so the port is held to its own contract: a request's tokens
do not depend on its co-tenants, the pool size or the chunk sizes.

Where the port differs on purpose: a row that fills its capacity exactly
has its index returned to 0 when it stops (the port writes the cache in
place, where JAX's functional update clamps), and a prompt whose width
bucket exceeds the capacity is admitted in a rectangle clamped to it (the
JAX engine fails there). `serve([])` raises ValueError in both."""

import jax
import numpy as np
import pytest
import torch

from transfusion_tpu.models.engine import ServingEngine as JaxEngine
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models import engine as engine_mod
from transfusion_tpu_torch.models import serving
from transfusion_tpu_torch.models.engine import ServingEngine
from transfusion_tpu_torch.training.metrics import MetricsLogger

torch.set_num_threads(1)
CFG = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,), pad_multiple=16)
SOS = 8


def tcfg(attn_impl="dense"):
    return dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl=attn_impl)


@pytest.fixture(scope="module")
def params():
    return JaxTransfusion(transformer=tcfg(), **CFG).init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(params):
    return port(params)


def port(params, attn_impl="dense"):
    tm = Transfusion(transformer=tcfg(attn_impl), device="cpu", **CFG)
    return tm.load_flax(jax.tree.map(np.asarray, params))


def solo(tm, prompt, n_new):
    out = tm.generate_text_only(np.asarray(prompt)[None], seq_len=len(prompt) + n_new,
                                temperature=0.0)
    return out[0].tolist()


PROMPTS = [[SOS, 1, 2], [SOS, 3, 4, 5, 6, 7], [SOS, 2], [SOS, 7, 1], [SOS, 5, 5, 5]]


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_engine_matches_jax_and_solo_greedy(params, attn_impl):
    """5 ragged requests through a 2-slot pool: later requests are admitted
    into dirty rows as earlier ones retire."""
    tm = port(params, attn_impl)
    jm = JaxTransfusion(transformer=tcfg(attn_impl), **CFG)
    n_new = 6
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    eng = ServingEngine(tm, max_batch=2, max_seq_len=64, decode_chunk=4, temperature=0.0)
    done = eng.run(prompts, n_new)
    assert len(done) == len(PROMPTS) and eng.stats["admitted"] == len(PROMPTS)
    assert eng.stats["generated_tokens"] == len(PROMPTS) * n_new
    got = {r.rid: r.tokens for r in done}
    je = JaxEngine(jm, params, max_batch=2, max_seq_len=64, decode_chunk=4, temperature=0.0)
    want = {r.rid: r.tokens for r in je.run(prompts, n_new)}
    assert got == want
    for rid, p in enumerate(PROMPTS):
        assert got[rid] == solo(tm, p, n_new), rid


def test_engine_early_finish_frees_slot(model):
    long_p = [SOS, 3, 4, 5, 6, 7]
    shorts = [[SOS, 1], [SOS, 2], [SOS, 4]]
    eng = ServingEngine(model, max_batch=2, max_seq_len=64, decode_chunk=2, temperature=0.0)
    rid_long = eng.submit(np.asarray(long_p, np.int32), 10)
    for s in shorts:
        eng.submit(np.asarray(s, np.int32), 2)
    by_rid = {r.rid: r for r in eng.run()}
    assert by_rid[rid_long].tokens == solo(model, long_p, 10)
    for i, s in enumerate(shorts):
        assert by_rid[i + 1].tokens == solo(model, s, 2)


def test_engine_eos_stops_early(model):
    prompt = [SOS, 1, 2]
    eos = solo(model, prompt, 1)[0]
    eng = ServingEngine(model, max_batch=2, max_seq_len=64, decode_chunk=4, temperature=0.0,
                        eos_id=eos)
    done = eng.run([np.asarray(prompt, np.int32)], 10)
    assert [r.tokens for r in done] == [[eos]]
    assert not eng.has_work


def test_engine_int8_smoke(params):
    tm = port(params, "flash")
    eng = ServingEngine(tm, max_batch=2, max_seq_len=64, decode_chunk=4, kv_quantize=True)
    assert eng.cache["k"].dtype == torch.int8 and "k_scale" in eng.cache
    done = eng.run([np.asarray([SOS, 1], np.int32), np.asarray([SOS, 2, 3], np.int32)], 4)
    assert len(done) == 2
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 8 for t in r.tokens)


def test_engine_capacity_guard(model):
    eng = ServingEngine(model, max_batch=1, max_seq_len=64)
    with pytest.raises(AssertionError, match="capacity"):
        eng.submit(np.ones(100, np.int32), 100)


def test_engine_sampled_reproducible_per_request(model):
    """temperature > 0: request 0's tokens are the same alone in a 1-slot
    pool and crowded in a 3-slot pool with other chunk sizes, and another
    seed draws differently."""
    prompt = np.asarray([SOS, 1, 2], np.int32)

    def run(pool, extra, chunk, seed=7):
        eng = ServingEngine(model, max_batch=pool, max_seq_len=64, decode_chunk=chunk,
                            temperature=1.0, seed=seed)
        eng.submit(prompt, 12)  # rid 0 everywhere
        for p in extra:
            eng.submit(np.asarray(p, np.int32), 14)
        return {r.rid: r.tokens for r in eng.run()}[0]

    alone = run(1, [], 8)
    crowded = run(3, [[SOS, 4, 5, 6], [SOS, 7], [SOS, 3, 3]], 2)
    assert alone == crowded and len(alone) == 12
    assert run(1, [], 8, seed=8) != alone


def test_engine_warmup_is_inert_then_matches_solo(model):
    """warmup() on a pool holding admitted requests leaves their index, mask
    and valid K/V slots as they were, records one clean sample per chunk
    length, and the run after it matches solo."""
    eng = ServingEngine(model, max_batch=2, max_seq_len=256, decode_chunk=8, temperature=0.0)
    prompts = [[SOS, 1, 2], [SOS, 3, 4, 5, 6]]
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), 6)
    eng._admit_pending()
    before = {k: v.clone() for k, v in eng.cache.items()}
    logits = eng.last_logits.clone()
    eng.warmup(fit_cap_slope=True)
    assert torch.equal(eng.cache["idx"], before["idx"])
    assert torch.equal(eng.cache["mask"], before["mask"])
    valid = before["mask"][None, :, None, :, None]
    for kk in ("k", "v"):
        assert torch.equal(torch.where(valid, eng.cache[kk], 0), torch.where(valid, before[kk], 0))
    assert torch.equal(eng.last_logits, logits)
    assert sorted(eng._chunk_samples) == [1, 2, 4, 8]
    assert all(len(v) == 2 and v[0] == 0.0 for v in eng._chunk_samples.values())
    assert eng._cost_frozen and eng.cost_fit != "priors"
    assert eng.stats["generated_tokens"] == 0
    by_rid = {r.rid: r.tokens for r in eng.run()}
    assert [by_rid[i] for i in range(2)] == [solo(model, p, 6) for p in prompts]


@pytest.mark.parametrize("force", ["engine", "static"])
def test_serve_routes_and_matches_solo(model, monkeypatch, force):
    prompts = [np.asarray(p, np.int32) for p in ([SOS, 1, 2], [SOS, 3, 4, 5], [SOS, 2])]
    budgets = [3, 5, 2]
    plans = []

    def plan(*a, **k):
        plans.append(force)
        return force

    monkeypatch.setattr(serving, "plan_dispatch", plan)
    eng = ServingEngine(model, max_batch=2, max_seq_len=128, decode_chunk=8, temperature=0.0)
    got = eng.serve(prompts, budgets)
    assert plans == [force]
    assert got == [solo(model, p.tolist(), b) for p, b in zip(prompts, budgets)]
    assert eng.stats["admitted"] == (3 if force == "engine" else 0)


def test_serve_empty_raises_as_jax(params, model):
    """`serve([])` raises ValueError in the JAX engine (engine.py:591,
    max() of no prompts); the port matches it."""
    jm = JaxTransfusion(transformer=tcfg(), **CFG)
    with pytest.raises(ValueError):
        JaxEngine(jm, params, max_batch=2, max_seq_len=64).serve([], 4)
    with pytest.raises(ValueError):
        ServingEngine(model, max_batch=2, max_seq_len=64).serve([], 4)


def test_engine_metrics_schema(model):
    """One row a tick with the JAX engine's keys and the port's admission
    and chunk clocks; admitted, retired and emitted tokens add up to the
    workload, the prompt tokens to the prompts, the prefill positions to
    each admitted prompt's width bucket, and the chunk's dispatch and fetch
    fit inside its time; no step on the CPU replays a graph."""
    log = MetricsLogger()
    eng = ServingEngine(model, max_batch=2, max_seq_len=256, decode_chunk=8, temperature=0.0,
                        metrics=log)
    prompts = [[SOS, 1], [SOS, 2, 3], [SOS, 4], [SOS] + [5] * 140]
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), 5)
    assert len(eng.run()) == len(prompts)
    assert len(log.history) >= 2
    want = {"admitted", "retired", "chunk_k", "chunk_seconds", "cost_model_residual_s",
            "emitted_tokens", "active_slots", "queue_depth", "admit_seconds", "prompt_tokens",
            "prefill_positions", "queued_seconds", "dispatch_seconds", "fetch_seconds",
            "graph_steps"}
    for row in log.history:
        assert want <= set(row), sorted(want - set(row))
        assert row["graph_steps"] == 0  # nothing is captured on the CPU
        assert row["prefill_positions"] >= row["prompt_tokens"]
        assert row["admit_seconds"] >= 0 and row["queued_seconds"] >= 0
        assert row["dispatch_seconds"] >= 0 and row["fetch_seconds"] >= 0
        assert row["dispatch_seconds"] + row["fetch_seconds"] <= row["chunk_seconds"]
    assert sum(r["admitted"] for r in log.history) == len(prompts)
    assert sum(r["retired"] for r in log.history) == len(prompts)
    assert sum(r["emitted_tokens"] for r in log.history) == 5 * len(prompts)
    assert sum(r["prompt_tokens"] for r in log.history) == sum(map(len, prompts))
    assert sum(r["prefill_positions"] for r in log.history) == 128 * 3 + 256
    assert log.ewma("chunk_k") is not None


def test_engine_chunk_samples_stop_growing_after_warmup(model):
    """warmup() freezes the cost model, so later chunks add no samples (a
    long-running server's lists stay bounded); before it, each chunk adds
    one."""
    eng = ServingEngine(model, max_batch=2, max_seq_len=256, decode_chunk=4, temperature=0.0)
    eng.run([np.asarray([SOS, 1], np.int32)], 3)
    assert sum(map(len, eng._chunk_samples.values())) >= 1
    eng.warmup(fit_cap_slope=False)
    frozen = {k: list(v) for k, v in eng._chunk_samples.items()}
    eng.run([np.asarray(p, np.int32) for p in ([SOS, 1, 2], [SOS, 3], [SOS, 4])], 9)
    assert eng._chunk_samples == frozen


def test_static_step_at_matches_jax(params, model):
    """static_step_at: None before a slope fit, then the JAX formula (the
    step less the slope times the dead slots, floored at 0.2 of the step)
    for the same fitted values; a warmup leaves a positive slope or None."""
    jm = JaxTransfusion(transformer=tcfg(), **CFG)
    je = JaxEngine(jm, params, max_batch=2, max_seq_len=1024)
    eng = ServingEngine(model, max_batch=2, max_seq_len=1024)
    assert eng.static_step_at(128) is None and je.static_step_at(128) is None
    for e in (je, eng):
        e._step_est, e._cap_slope = 0.004, 2e-6
    for cap in (128, 256, 640, 1024, 2048):
        assert eng.static_step_at(cap) == je.static_step_at(cap), cap
    assert serving.plan_dispatch([16] * 4, 2, 0.01, 0.004, static_step_s=eng.static_step_at(128)) \
        in ("engine", "static")
    fresh = ServingEngine(model, max_batch=2, max_seq_len=256, decode_chunk=4)
    fresh.warmup(fit_cap_slope=True)
    assert fresh._cap_slope is None or fresh._cap_slope > 0


def test_row_filled_to_capacity_then_more_requests(params, model):
    """Trouble spot of the in-place cache: a 100-token prompt with 28 new
    tokens fills its 128-slot row exactly and retires mid-chunk while its
    co-tenant decodes on; the inert steps after it must not write past the
    capacity, and the requests admitted into that row afterwards match JAX
    and solo."""
    rng = np.random.default_rng(3)
    full = [SOS] + rng.integers(0, 8, 99).tolist()
    prompts = [full, [SOS, 3, 4], [SOS, 5], [SOS, 6, 1, 2]]
    budgets = [28, 40, 9, 7]
    eng = ServingEngine(model, max_batch=2, max_seq_len=128, decode_chunk=16, temperature=0.0)
    assert eng.cap == 128
    jm = JaxTransfusion(transformer=tcfg(), **CFG)
    je = JaxEngine(jm, params, max_batch=2, max_seq_len=128, decode_chunk=16, temperature=0.0)
    for e in (eng, je):
        for p, b in zip(prompts, budgets):
            e.submit(np.asarray(p, np.int32), b)
    got = {r.rid: r.tokens for r in eng.run()}
    want = {r.rid: r.tokens for r in je.run()}
    assert got == want
    for rid, (p, b) in enumerate(zip(prompts, budgets)):
        assert got[rid] == solo(model, p, b), rid
    assert eng.cache["idx"].tolist() == [0, 0]  # every row freed, its index reset


def test_decode_chunk_resets_a_stopped_rows_index(model):
    """One chunk by hand: a row at slot cap - 1 with one token of budget
    writes its last slot and stops; its index returns to 0 and the 3 inert
    steps after it write slot 0 masked invalid. An idle row stays pinned."""
    cap = 128
    cache = model._cache(2, cap, False, track_mask=True)
    cache["mask"][0, : cap - 1] = True
    cache["mask"][1, :5] = True
    cache["idx"] = torch.tensor([cap - 1, 5], dtype=torch.int32)
    last = torch.zeros(2, model.vocab_size)
    graph = engine_mod.DecodeGraph(model, cache, last, temperature=0.0, min_p=0.0, eos_id=None)
    payload = graph.chunk(torch.tensor([True, False]), torch.tensor([1, 0], dtype=torch.int32),
                          None, k=4)
    assert payload.shape == (2, 9)
    assert payload[:, 4:].tolist() == [[1, 0, 0, 0, 0], [0, 0, 0, 0, 0]]
    assert cache["idx"].tolist() == [0, 5]
    assert cache["mask"][0, cap - 1] and not cache["mask"][0, 0]
    assert cache["mask"].sum(1).tolist() == [cap - 1, 5]
    assert torch.isfinite(last).all()


def test_admission_clamps_the_width_bucket_to_the_capacity(model):
    """A 260-token prompt (width bucket 512) in a 384-slot pool is admitted
    in a 384-wide rectangle (the JAX engine's prefill fails here) and
    decodes as its solo run does."""
    rng = np.random.default_rng(4)
    prompt = [SOS] + rng.integers(0, 8, 259).tolist()
    eng = ServingEngine.for_workload(model, [prompt, [SOS, 1]], [100, 6], max_batch=2,
                                     decode_chunk=32, temperature=0.0)
    assert eng.cap == 384
    eng.submit(np.asarray(prompt, np.int32), 100)
    eng.submit(np.asarray([SOS, 1], np.int32), 6)
    got = {r.rid: r.tokens for r in eng.run()}
    assert got[0] == solo(model, prompt, 100) and got[1] == solo(model, [SOS, 1], 6)


def eager_chunk(model, cache, last, active, left, gumbel, *, k, temperature, min_p, eos_id):
    """The plain reference of a chunk: k `_decode_step`s on tensors rebound
    at each step (no static buffer), stacked into the engine's payload
    [B, 2k + 1]. Returns (cache, last logits, payload)."""
    text_only = engine_mod._text_ids(model, last.device)
    toks, emits = [], []
    for j in range(k):
        emits.append(active)
        cache, last, active, left, tok = engine_mod._decode_step(
            model, cache, last, active, left, None if gumbel is None else gumbel[j], text_only,
            temperature=temperature, min_p=min_p, eos_id=eos_id)
        toks.append(tok)
    payload = torch.cat([torch.stack(toks, 1), torch.stack(emits, 1).long(),
                         active[:, None].long()], dim=1)
    return cache, last, payload


# (engine options, prompts, budgets, chunk length): the captured step's cases
STATIC_STEP_CASES = {
    "greedy": (dict(), [[SOS, 1, 2], [SOS, 3, 4, 5]], [20, 20], 8),
    "sampled": (dict(temperature=1.0, min_p=0.1), [[SOS, 1, 2], [SOS, 3, 4, 5]], [20, 20], 8),
    "eos": (dict(eos_id="first greedy token"), [[SOS, 1, 2], [SOS, 6]], [20, 20], 8),
    "budget": (dict(), [[SOS, 1, 2], [SOS, 3], [SOS, 7, 7]], [3, 5, 20], 8),
    "full row": (dict(), [[SOS] + [3] * 99, [SOS, 2]], [28, 40], 32),
    "int8": (dict(kv_quantize=True), [[SOS, 1, 2], [SOS, 3, 4, 5]], [6, 20], 8),
}


@pytest.mark.parametrize("case", list(STATIC_STEP_CASES))
def test_static_step_matches_the_eager_chunk(params, case):
    """`DecodeGraph`'s step (the body a CUDA device captures), run eagerly
    on its static buffers k times a chunk for two chunks, against
    `eager_chunk` on a copy of the same pool: the payloads are equal token
    for token, and the static buffers hold the eager chunk's cache, last
    logits and active flags."""
    opts, prompts, budgets, k = STATIC_STEP_CASES[case]
    tm = port(params, "flash" if opts.get("kv_quantize") else "dense")
    eng = ServingEngine(tm, max_batch=len(prompts), max_seq_len=128,
                        **{o: v for o, v in opts.items() if o != "eos_id"})
    for p, b in zip(prompts, budgets):
        eng.submit(np.asarray(p, np.int32), b)
    eng._admit_pending()
    eos_id = None
    if "eos_id" in opts:  # row 0 stops on EOS at its first step
        masked = torch.where(engine_mod._text_ids(tm, "cpu"), eng.last_logits, float("-inf"))
        eos_id = int(masked[0].argmax())
    kw = dict(temperature=eng.temperature, min_p=eng.min_p, eos_id=eos_id)
    cache = {key: t.clone() for key, t in eng.cache.items()}
    last = eng.last_logits.clone()
    graph = engine_mod.DecodeGraph(tm, eng.cache, eng.last_logits, **kw)
    active = torch.ones(len(prompts), dtype=torch.bool)
    left = torch.tensor(budgets, dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    emitted, payloads = 0, []
    for _ in range(2):
        gumbel = None
        if eng.temperature > 0:
            gumbel = -torch.log(-torch.log(torch.rand(k, len(prompts), tm.vocab_size,
                                                      generator=gen)))
        cache, last, want = eager_chunk(tm, cache, last, active, left, gumbel, k=k, **kw)
        got = graph.chunk(active, left, gumbel, k=k)
        assert torch.equal(got, want)
        payloads.append(want)
        for key in cache:
            assert torch.equal(graph.cache[key], cache[key]), key
        assert torch.equal(graph.last, last)
        assert torch.equal(graph.active, want[:, -1].bool())
        emits = want[:, k : 2 * k].sum(1)
        emitted += int(emits.sum())
        left = left - emits.to(torch.int32)
        active = want[:, -1].bool()
    assert graph.graph is None and graph.replays == 0
    if case == "eos":
        first = payloads[0]
        assert first[0, k] == 1 and first[0, k + 1 :].sum() == 0 and first[1, k + 1] == 1
    elif case == "full row":  # the row fills its 128 slots, its index returns to 0 and the
        # inert steps after it write slot 0, masked invalid
        assert emitted == 28 + 40 and cache["idx"][0] == 0
        assert cache["mask"][0, 1:].all() and not cache["mask"][0, 0]
    elif case != "sampled":
        assert emitted == sum(min(b, 2 * k) for b in budgets)
