"""PyTorch port: batched multimodal sampling (`models/sample_batch.py`,
`Transfusion.sample_batch`) against the JAX package's `sample_batch` with
the same weights, and against the port's own solo `sample(cache_kv=True)`,
float32 on the CPU, following tests/test_sample_batch.py: at temperature 0
with pinned modality noise a request's output does not depend on its
co-tenants.

Token parity with JAX stands only at temperature 0 with
`init_modality_noise`: the port's per-request streams are its own. Above
temperature 0 the port is held to its own contract: two runs are equal and
a request alone reproduces itself in a batch."""

import jax
import numpy as np
import pytest
import torch

from transfusion_tpu.models import sample_batch as jax_sb
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models import sample_batch as sb

torch.set_num_threads(1)
CFG = dict(num_text_tokens=32, dim_latent=8, modality_default_shape=(3,), pad_multiple=16)


def tcfg(attn_impl="dense"):
    return dict(dim=32, depth=2, dim_head=16, heads=2, attn_impl=attn_impl)


@pytest.fixture(scope="module")
def params():
    return JaxTransfusion(transformer=tcfg(), **CFG).init_params(jax.random.PRNGKey(0))


def pair(params, attn_impl="dense", **kw):
    jm = JaxTransfusion(transformer=tcfg(attn_impl), **CFG, **kw)
    tm = Transfusion(transformer=tcfg(attn_impl), device="cpu", **CFG, **kw)
    tm.load_flax(jax.tree.map(np.asarray, params))
    return jm, tm


def make_prompts(m):
    rng = np.random.default_rng(0)
    p0 = [rng.integers(0, 32, 5).astype(np.int32)]  # plain text continuation
    p1 = [np.asarray([3, 1, m.som_ids[0]], np.int32)]  # ends in [som]: default shape
    p2 = (0, rng.normal(size=(3, 8)).astype(np.float32))  # a modality prompt
    return [p0, p1, p2]


NOISE = np.asarray(np.random.default_rng(7).normal(size=(16, 8)), np.float32)
GREEDY = dict(text_temperature=0.0, text_min_p=0.0, init_modality_noise=NOISE,
              kv_quantize=False, return_unprocessed_modalities=True)


def assert_items_equal(a, b, atol):
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and x[0] == y[0]
            np.testing.assert_allclose(np.asarray(x[1]), np.asarray(y[1]), atol=atol, rtol=1e-4)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def check(tm, jm, params, prompts, atol=2e-5, **kw):
    """The port's batch against JAX's batch and each request against the
    port's solo cached sample."""
    kw = {**GREEDY, **kw}
    got = tm.sample_batch(prompts, **kw)
    want = jm.sample_batch(params, prompts, rng=jax.random.PRNGKey(1), **kw)
    assert len(got) == len(want) == len(prompts)
    budgets = kw.pop("max_length")
    budgets = budgets if isinstance(budgets, list) else [budgets] * len(prompts)
    for p, b, g, w in zip(prompts, budgets, got, want):
        assert_items_equal(g, w, atol)
        assert_items_equal(g, tm.sample(p, cache_kv=True, max_length=b, **kw), atol)
    return got


@pytest.mark.parametrize("attn_impl,cfg_scale", [("dense", 1.0), ("dense", 3.0),
                                                 ("flash", 3.0)])
def test_sample_batch_matches_jax_and_solo(params, attn_impl, cfg_scale):
    """(The JAX side of the flash case runs dense: its sample_batch has no
    flash test, and its dense and flash routes agree to float32 rounding.)"""
    _, tm = pair(params, attn_impl)
    jm, _ = pair(params)
    out = check(tm, jm, params, make_prompts(tm), max_length=6, modality_steps=3,
                cfg_scale=cfg_scale)
    assert any(isinstance(o, tuple) for o in out[1])


def test_sample_batch_per_request_budgets(params):
    jm, tm = pair(params)
    check(tm, jm, params, make_prompts(tm), max_length=[3, 7, 5], modality_steps=3,
          cfg_scale=1.0)


def test_sample_batch_capacity_rebuild(params, monkeypatch):
    """A segment that overflows the pool's capacity rebuilds the pool (a
    fresh prefill at a larger capacity); the results still match. Both
    packages start from a 16-slot cap."""
    jm, tm = pair(params)
    prompts = [[np.asarray([3] * 10 + [1, tm.som_ids[0]], np.int32)],
               [np.asarray([2, 4, 6], np.int32)]]
    calls = {"port": 0, "jax": 0}

    def tight(orig, side):
        def round_up(n, mult):
            calls[side] += 1
            return 16 if calls[side] == 1 else orig(n, mult)  # the initial cap only
        return round_up

    monkeypatch.setattr(sb, "_round_up", tight(sb._round_up, "port"))
    monkeypatch.setattr(jax_sb, "_round_up", tight(jax_sb._round_up, "jax"))
    got = tm.sample_batch(prompts, max_length=5, modality_steps=2, cfg_scale=1.0, **GREEDY)
    want = jm.sample_batch(params, prompts, rng=jax.random.PRNGKey(1), max_length=5,
                           modality_steps=2, cfg_scale=1.0, **GREEDY)
    monkeypatch.undo()
    assert calls["port"] >= 2 and calls["jax"] >= 2, f"a rebuild path never ran: {calls}"
    for p, g, w in zip(prompts, got, want):
        assert_items_equal(g, w, 2e-5)
        assert_items_equal(g, tm.sample(p, cache_kv=True, max_length=5, modality_steps=2,
                                        cfg_scale=1.0, **GREEDY), 2e-5)


def test_sample_batch_adaptive_ode_grouped(params):
    """odeint_method='adaptive' through the grouped ODE (per-row control,
    `odeint_adaptive_rows`), CFG 3.0: tokens equal to JAX's and to solo;
    latents within 1e-3. The controller takes ~1200 Heun steps on this
    flow, which carry float32 rounding differences (the pool's shapes
    against solo's, torch against XLA) far past a fixed grid's 2e-5."""
    jm, tm = pair(params, odeint_method="adaptive")
    check(tm, jm, params, make_prompts(tm), atol=1e-3, max_length=6, modality_steps=3,
          cfg_scale=3.0)


def test_sample_batch_reproducible_above_temperature_zero(params):
    """Per-request streams of (seed, request, count): two runs are equal,
    and request 0 alone reproduces its stream in the batch."""
    _, tm = pair(params)
    prompts = make_prompts(tm)
    kw = dict(max_length=5, text_temperature=1.0, modality_steps=2, cfg_scale=1.0, seed=3)
    a = tm.sample_batch(prompts, **kw)
    b = tm.sample_batch(prompts, **kw)
    for x, y in zip(a, b):
        assert_items_equal(x, y, atol=0)
    c = tm.sample_batch(prompts[:1], **kw)
    assert_items_equal(a[0], c[0], atol=1e-5)
    d = tm.sample_batch(prompts[:1], **dict(kw, seed=4))
    assert len(d) == 1
    with pytest.raises(ValueError, match="budgets"):
        tm.sample_batch(prompts, max_length=[3, 4])


def test_chunk_tick_pins_idle_rows():
    """One chunk by hand: an idle row's slot is written but stays invalid
    and its index does not move; an active row stops on its budget."""
    tm = Transfusion(transformer=tcfg(), device="cpu", **CFG)
    R = 2
    cache = tm._cache(2 * R, 32, False, track_mask=True)
    cache["mask"][:, :3] = True
    cache["idx"] = torch.full((2 * R,), 3, dtype=torch.int32)
    payload, cache = sb._chunk_tick_impl(
        tm, cache, torch.tensor([5, 0]), torch.tensor([3, 3, 3, 3]),
        torch.tensor([True, False]), torch.tensor([2, 0]), None, temperature=0.0, min_p=0.0,
        R=R, k=4, stop_ids=torch.tensor([-1]))  # no stop id: the budget stops
    assert payload.shape == (R, 8)
    assert payload[0, 4:].tolist() == [1, 1, 0, 0] and payload[1, 4:].tolist() == [0] * 4
    assert cache["idx"].tolist() == [5, 3, 5, 3]
    assert cache["mask"].sum(1).tolist() == [5, 3, 5, 3]
    assert torch.isfinite(cache["k"]).all()


def test_sample_batch_prompt_bucket_wider_than_the_capacity(params):
    """A 600-token prompt packs to a 1024-wide bucket while the pool holds
    896 slots: the port's prefill packs at most the capacity wide and
    matches the solo run; the JAX `sample_batch` fails on this input (its
    prefill cannot write a chunk wider than the cache), a reference caveat
    recorded in ROADMAP.md."""
    jm, tm = pair(params)
    prompt = [np.arange(599).astype(np.int32) % 32]
    kw = dict(GREEDY, max_length=6, modality_steps=2, cfg_scale=1.0)
    with pytest.raises(ValueError):
        jm.sample_batch(params, [prompt], rng=jax.random.PRNGKey(1), **kw)
    got = tm.sample_batch([prompt], **kw)
    assert_items_equal(got[0], tm.sample(prompt, cache_kv=True, **kw), 2e-5)
