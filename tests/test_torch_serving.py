"""PyTorch port: the serving entry points against the JAX package with the
same weights (carried by `weights.from_flax`), float32 on the CPU.

JAX and torch random generators cannot give the same draws, so parity is
tested greedily (temperature 0: tokens must be equal) and, for the ODE,
with the initial noise injected through `init_modality_noise` (latents at
atol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion

torch.set_num_threads(1)
CFG = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,), pad_multiple=16)
TCFG = dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="flash")


@pytest.fixture(scope="module")
def pair():
    """JAX flash model (params initialized through the cheaper dense twin,
    same tree) and the port with the same weights."""
    dense = JaxTransfusion(transformer=dict(TCFG, attn_impl="dense"), **CFG)
    params = dense.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(42)

    def jitter(path, p):
        nonlocal key
        key, k = jax.random.split(key)
        return p + jax.random.normal(k, p.shape) * 0.05

    params = jax.tree_util.tree_map_with_path(jitter, params)
    jm = JaxTransfusion(transformer=TCFG, **CFG)
    tm = Transfusion(transformer=TCFG, device="cpu", **CFG)
    tm.load_flax(jax.tree.map(np.asarray, params))
    return jm, params, tm


PROMPTS = [[8, 1, 2], [8, 3, 4, 5, 6, 7], [8, 2]]


@pytest.mark.parametrize("kv_quantize", [False, True])
def test_generate_text_batch_greedy_matches_jax(pair, kv_quantize):
    jm, params, tm = pair
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    out_j = jm.generate_text_batch(params, prompts, max_new_tokens=6, temperature=0.0,
                                   kv_quantize=kv_quantize, rng=jax.random.PRNGKey(0))
    out_t = tm.generate_text_batch(prompts, max_new_tokens=6, temperature=0.0,
                                   kv_quantize=kv_quantize)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_generate_text_only_rectangular_greedy_matches_jax(pair):
    jm, params, tm = pair
    prompt = np.asarray([[8, 1, 2, 3], [8, 4, 5, 6]], np.int32)
    out_j = jm.generate_text_only(params, prompt, seq_len=12, temperature=0.0,
                                  kv_quantize=False, rng=jax.random.PRNGKey(0))
    out_t = tm.generate_text_only(prompt, seq_len=12, temperature=0.0)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # ragged with equal lengths takes the per-row path and must agree
    ragged = tm.generate_text_only(prompt, seq_len=12, temperature=0.0, prompt_lengths=[4, 4])
    np.testing.assert_array_equal(ragged.numpy(), out_t.numpy())


def test_generate_text_sampled_is_seeded_and_text_only(pair):
    _, _, tm = pair
    prompts = [np.asarray(p) for p in PROMPTS]
    a, b = (tm.generate_text_batch(prompts, max_new_tokens=5, temperature=1.0,
                                   generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 8)).all()


@pytest.mark.parametrize("cfg_scale,incremental", [(3.0, True), (3.0, False), (1.0, True)])
def test_cached_sample_latents_match_jax(pair, cfg_scale, incremental):
    """sample(cache_kv=True) with greedy text and injected noise: the same
    token stream and latents within 1e-3, with and without CFG."""
    jm, params, tm = pair
    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, 2, jm.som_ids[0]], np.int32)], max_length=8,
              modality_steps=4, init_modality_noise=noise, cfg_scale=cfg_scale,
              text_temperature=0.0, cache_kv=True, incremental_cfg_cache=incremental)
    out_j = jm.sample(params, rng=jax.random.PRNGKey(1), return_unprocessed_modalities=True,
                      kv_quantize=False, **kw)
    out_t = tm.sample(**kw)
    assert len(out_j) == len(out_t)
    for a, b in zip(out_t, out_j):
        if isinstance(a, tuple):
            assert a[0] == b[0] and a[1].shape == b[1].shape == (4, 16)
            np.testing.assert_allclose(a[1], np.asarray(b[1]), atol=1e-3)
        else:
            np.testing.assert_array_equal(a, np.asarray(b))


def test_uncached_sample_and_bad_prompts_raise(pair):
    """Uncached sample() no longer raises (tests/test_torch_uncached_sampling.py
    holds it against JAX): its greedy tokens equal the cached loop's. Bad
    prompts still raise."""
    _, _, tm = pair
    kw = dict(prompt=[np.asarray([1])], max_length=3, text_temperature=0.0)
    for a, b in zip(tm.sample(**kw), tm.sample(cache_kv=True, **kw)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="at least one prompt"):
        tm.sample_batch([])
    with pytest.raises(ValueError, match="every prompt needs"):
        tm.generate_text_batch([np.asarray([], np.int32)], max_new_tokens=2)


def test_parse_modality_shape_matches_jax(pair):
    jm, _, tm = pair
    seq = np.asarray([jm.meta_id] + [jm.char_offset + ord(c) for c in "6"] + [jm.som_ids[0]])
    assert tm._parse_modality_shape(seq, 0) == jm._parse_modality_shape(seq, 0) == (6,)
    bad = np.asarray([jm.meta_id, jm.char_offset + ord("x"), jm.som_ids[0]])
    assert tm._parse_modality_shape(bad, 0) == jm._parse_modality_shape(bad, 0) == (4,)
    prompt = (0, np.ones((3, 16), np.float32))
    for a, b in zip(tm._prompt_to_items(prompt), jm._prompt_to_items(prompt)):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)
