"""PyTorch port: the continuous-batching multimodal engine
(`models/engine_mm.py`) against the JAX package's
`MultimodalServingEngine` with the same weights, and against the port's own
solo `sample(cache_kv=True)`, float32 on the CPU, following
tests/test_engine_mm.py: at temperature 0 with pinned modality noise every
request's output equals its solo run within 2e-5, with a queue deeper than
the pool and through a capacity rebuild.

Where the port differs on purpose, and what is held instead:

  * Randomness: above temperature 0 the port's draws come from the streams
    of its `sample_batch`, keyed by (seed, request id, count); a request's
    output does not depend on the pool size, and the engine reproduces
    `sample_batch` where request ids equal batch indices.
  * KV policy: `kv_quantize=None` resolves through the port's
    `plan_serving` (no int8 unless requested), not JAX's TPU crossovers.
  * In-place writes: a freed slot's index and mask return to 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.models.engine_mm import MultimodalServingEngine as JaxEngine
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models import serving
from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine
from transfusion_tpu_torch.training.metrics import MetricsLogger

torch.set_num_threads(1)
CFG = dict(num_text_tokens=32, dim_latent=8, modality_default_shape=(3,), pad_multiple=16)
PIN_NOISE = np.asarray(np.random.default_rng(7).normal(size=(16, 8)), np.float32)
GREEDY = dict(text_temperature=0.0, text_min_p=0.0, init_modality_noise=PIN_NOISE,
              return_unprocessed_modalities=True)


def tcfg(attn_impl="dense"):
    return dict(dim=32, depth=2, dim_head=16, heads=2, attn_impl=attn_impl)


@pytest.fixture(scope="module")
def params():
    return JaxTransfusion(transformer=tcfg(), **CFG).init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(params):
    return port(params)


def port(params, attn_impl="dense"):
    tm = Transfusion(transformer=tcfg(attn_impl), device="cpu", **CFG)
    return tm.load_flax(jax.tree.map(np.asarray, params))


def jax_model():
    return JaxTransfusion(transformer=tcfg(), dtype=jnp.float32, **CFG)


def make_prompts(m):
    rng = np.random.default_rng(0)
    p0 = [rng.integers(0, 32, 5).astype(np.int32)]  # plain text continuation
    p1 = [np.asarray([3, 1, m.som_ids[0]], np.int32)]  # ends in [som]: default shape
    p2 = (0, rng.normal(size=(3, 8)).astype(np.float32))  # a modality prompt
    return [p0, p1, p2]


def assert_items_equal(a, b, atol):
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and x[0] == y[0]
            np.testing.assert_allclose(np.asarray(x[1]), np.asarray(y[1]), atol=atol, rtol=1e-4)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def solo(tm, prompt, **kw):
    kw = {**GREEDY, **kw}
    kw.pop("return_unprocessed_modalities")
    return tm.sample(prompt, cache_kv=True, kv_quantize=False, **kw)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_mm_engine_matches_jax_and_solo(params, attn_impl):
    """5 requests through 2 slots, CFG 3.0. (The JAX side runs dense, as in
    tests/test_torch_sample_batch.py: its dense and flash routes agree to
    float32 rounding.)"""
    tm = port(params, attn_impl)
    base = make_prompts(tm)
    prompts = base + [base[0], base[1]]
    kw = dict(cfg_scale=3.0, modality_steps=3, **GREEDY)
    eng = MultimodalServingEngine.for_workload(tm, prompts, 6, max_requests=2, **kw)
    rids = [eng.submit(p, max_length=6) for p in prompts]
    got = {f.rid: f.output for f in eng.run()}
    assert eng.stats["admitted"] == len(prompts) and eng.stats["rebuilds"] == 0
    je = JaxEngine.for_workload(jax_model(), params, prompts, 6, max_requests=2,
                                rng=jax.random.PRNGKey(1), **kw)
    for p in prompts:
        je.submit(p, max_length=6)
    want = {f.rid: f.output for f in je.run()}
    for rid, p in zip(rids, prompts):
        assert_items_equal(got[rid], want[rid], 2e-5)
        assert_items_equal(got[rid], solo(tm, p, max_length=6, modality_steps=3,
                                          cfg_scale=3.0), 2e-5)
    assert any(isinstance(o, tuple) for o in got[1])
    # every slot freed: index 0 and an empty mask
    assert eng.cache["idx"].tolist() == [0] * eng.rows and not eng.cache["mask"].any()


def test_mm_engine_reproducible_across_pool_sizes(model):
    """temperature 1: the same request ids give the same outputs in a 1-slot
    and a 3-slot pool, and `sample_batch` with the same seed gives them too
    (its request index is the id)."""
    prompts = make_prompts(model)
    kw = dict(cfg_scale=1.0, modality_steps=2, text_temperature=1.0,
              return_unprocessed_modalities=True, seed=3)

    def run(pool):
        eng = MultimodalServingEngine(model, max_requests=pool, max_seq_len=128, **kw)
        return {f.rid: f.output for f in eng.run(prompts, max_length=5)}

    a, b = run(1), run(3)
    assert set(a) == set(b) == {0, 1, 2}
    batch = model.sample_batch(prompts, max_length=5, **kw)
    for rid in a:
        assert_items_equal(a[rid], b[rid], 1e-5)
        assert_items_equal(a[rid], batch[rid], 1e-5)


def test_mm_engine_capacity_rebuild_matches_jax(params, model):
    """A 126-token [som] prompt fits the 128-slot pool at admission but its
    segment does not: the first ODE group rebuilds the pool, and a text
    request rides through it."""
    prompts = [[np.asarray([3] * 123 + [1, model.som_ids[0]], np.int32)],
               [np.asarray([2, 4, 6], np.int32)]]
    kw = dict(cfg_scale=1.0, modality_steps=2, **GREEDY)
    eng = MultimodalServingEngine(model, max_requests=2, max_seq_len=1, **kw)
    je = JaxEngine(jax_model(), params, max_requests=2, max_seq_len=1,
                   rng=jax.random.PRNGKey(1), **kw)
    assert eng.cap == je.cap == 128
    for e in (eng, je):
        for p in prompts:
            e.submit(p, max_length=5)
    got = {f.rid: f.output for f in eng.run()}
    want = {f.rid: f.output for f in je.run()}
    assert eng.stats["rebuilds"] == je.stats["rebuilds"] >= 1
    for rid, p in enumerate(prompts):
        assert_items_equal(got[rid], want[rid], 2e-5)
        assert_items_equal(got[rid], solo(model, p, max_length=5, modality_steps=2,
                                          cfg_scale=1.0), 2e-5)


def test_mm_engine_submit_capacity_assert(model):
    eng = MultimodalServingEngine(model, max_requests=1, max_seq_len=128)
    with pytest.raises(AssertionError, match="raise max_seq_len"):
        eng.submit([np.zeros(200, np.int32)], max_length=4)


def test_mm_engine_warmup_inert_and_cost_model(model):
    """warmup() times the chunk ladder and the grouped ODE on inert rows of
    a pool holding admitted requests: index, mask and valid K/V slots stay
    as they were, the cost model is seeded and frozen, and the run after it
    matches solo."""
    prompts = make_prompts(model)
    kw = dict(cfg_scale=1.0, modality_steps=3, **GREEDY)
    eng = MultimodalServingEngine.for_workload(model, prompts, 6, max_requests=2, **kw)
    rids = [eng.submit(p, max_length=6) for p in prompts]
    eng._admit_pending()
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.warmup()
    assert torch.equal(eng.cache["idx"], before["idx"])
    assert torch.equal(eng.cache["mask"], before["mask"])
    valid = before["mask"][None, :, None, :, None]
    for kk in ("k", "v"):
        assert torch.equal(torch.where(valid, eng.cache[kk], 0), torch.where(valid, before[kk], 0))
    assert eng._cost_frozen
    k = 1
    while k <= eng.text_chunk:
        assert len(eng._chunk_samples[k]) == 2 and eng._chunk_samples[k][0] == 0.0, k
        k <<= 1
    assert eng.ode_cost() > 0 and eng.ode_cost(0, (3,)) == eng.ode_cost()
    got = {f.rid: f.output for f in eng.run()}
    for rid, p in zip(rids, prompts):
        assert_items_equal(got[rid], solo(model, p, max_length=6, modality_steps=3,
                                          cfg_scale=1.0), 2e-5)


def test_mm_engine_warmup_takes_the_jax_signature(model, caplog):
    """A warmup call written for the JAX engine runs: its prompt_widths and
    group_sizes only choose compiles there, and are ignored (logged)."""
    eng = MultimodalServingEngine(model, max_requests=2, max_seq_len=64, modality_steps=2,
                                  **GREEDY)
    with caplog.at_level("INFO", logger="transfusion_tpu_torch.models.engine_mm"):
        eng.warmup(shapes=[(0, (3,))], prompt_widths=[16, 32], group_sizes=[1, 2])
    assert eng._cost_frozen and eng.ode_cost(0, (3,)) > 0
    assert any("ignored" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("plan", ["engine", "waves"])
def test_mm_engine_serve_routes(model, monkeypatch, plan):
    prompts = make_prompts(model)
    kw = dict(cfg_scale=1.0, modality_steps=3, **GREEDY)
    monkeypatch.setattr(serving, "plan_dispatch_mm", lambda *a, **k: plan)
    eng = MultimodalServingEngine.for_workload(model, prompts, 6, max_requests=2, **kw)
    outs = eng.serve(prompts, 6)
    assert eng.stats["admitted"] == (len(prompts) if plan == "engine" else 0)
    for got, p in zip(outs, prompts):
        assert_items_equal(got, solo(model, p, max_length=6, modality_steps=3, cfg_scale=1.0),
                           2e-5)


def test_mm_engine_serve_per_request_budgets(model):
    """serve() takes a budget and an expected segment count per prompt;
    plan_only decides without admitting anything."""
    prompts = make_prompts(model)
    kw = dict(cfg_scale=1.0, modality_steps=3, **GREEDY)
    eng = MultimodalServingEngine.for_workload(model, prompts, 8, max_requests=2, **kw)
    budgets = [8, 6, 6]
    plan = eng.serve(prompts, budgets, expected_segments=[1.0] * 3, plan_only=True)
    assert plan in ("engine", "waves") and eng.stats["admitted"] == 0
    outs = eng.serve(prompts, budgets)
    for got, p, b in zip(outs, prompts, budgets):
        assert_items_equal(got, solo(model, p, max_length=b, modality_steps=3, cfg_scale=1.0),
                           2e-5)


def test_mm_engine_metrics_schema(model):
    prompts = make_prompts(model)
    log = MetricsLogger()
    eng = MultimodalServingEngine.for_workload(
        model, prompts, 6, max_requests=2, cfg_scale=1.0, modality_steps=2,
        text_temperature=0.0, init_modality_noise=PIN_NOISE, metrics=log)
    assert len(eng.run(prompts, max_length=6)) == len(prompts)
    assert len(log.history) >= 1
    want = {"admitted", "retired", "chunk_k", "chunk_seconds", "cost_model_residual_s",
            "ode_groups", "seg_ewma", "active_slots", "queue_depth"}
    for row in log.history:
        assert want <= set(row), sorted(want - set(row))
    assert sum(r["admitted"] for r in log.history) == len(prompts)
    assert sum(r["retired"] for r in log.history) == len(prompts)


def test_mm_engine_kv_policy_is_the_ports(model):
    """kv_quantize=None takes the port's plan_serving: a float cache; an
    explicit True an int8 one, which still serves."""
    eng = MultimodalServingEngine(model, max_requests=2, max_seq_len=128)
    assert eng._quantize is False and "k_scale" not in eng.cache
    assert eng._quantize == model._plan(eng.cap, eng.rows, None).kv_quantize
    q = MultimodalServingEngine(model, max_requests=2, max_seq_len=128, kv_quantize=True,
                                cfg_scale=1.0, modality_steps=2, **GREEDY)
    assert q._quantize is True and q.cache["k"].dtype == torch.int8
    out = q.run(make_prompts(model)[:2], max_length=5)
    assert len(out) == 2
