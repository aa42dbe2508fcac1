"""PyTorch port: the uncached entry points against the JAX package with the
same weights (carried by `weights.from_flax`), float32 on the CPU:
`forward_text`, `forward_modality`, `forward` / `__call__`,
`generate_modality_only` and `sample(cache_kv=False)`.

The JAX side runs as its own tests run it: `attn_impl="dense"`, or "flash"
with its Pallas kernels in interpret mode. Draws are explicit: the
modality loss takes JAX's (times, noise) derived from its key schedule,
`generate_modality_only` JAX's noise, and `sample` greedy text with
`init_modality_noise`."""

import jax
import numpy as np
import pytest
import torch

from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion

torch.set_num_threads(1)
CFG = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,), pad_multiple=16)


def tcfg(attn_impl):
    return dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl=attn_impl)


@pytest.fixture(scope="module")
def params():
    """The dense twin's params (the same tree for both attention routes),
    jittered so that no module sits at its zero init."""
    dense = JaxTransfusion(transformer=tcfg("dense"), **CFG)
    p = dense.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(42)

    def jitter(path, x):
        nonlocal key
        key, k = jax.random.split(key)
        return x + jax.random.normal(k, x.shape) * 0.05

    return jax.tree_util.tree_map_with_path(jitter, p)


def pair(params, attn_impl, **kw):
    jm = JaxTransfusion(transformer=tcfg(attn_impl), **CFG, **kw)
    tm = Transfusion(transformer=tcfg(attn_impl), device="cpu", **CFG, **kw)
    tm.load_flax(jax.tree.map(np.asarray, params))
    return jm, tm


def assert_items(out_t, out_j, atol=1e-3):
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        if isinstance(a, tuple):
            assert isinstance(b, tuple) and a[0] == b[0] and a[1].shape == np.asarray(b[1]).shape
            np.testing.assert_allclose(a[1], np.asarray(b[1]), atol=atol)
        else:
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_text_matches_jax(params, attn_impl):
    """Logits (1e-5) and the text-vocabulary CE with ignore_index (1e-4)."""
    jm, tm = pair(params, attn_impl)
    text = np.random.default_rng(0).integers(0, 8, (2, 12)).astype(np.int32)
    text[1, 7:] = -1  # ignore_index
    logits_j = jm.forward_text(params, text, return_loss=False)
    logits_t = tm.forward_text(text, return_loss=False)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-5)
    loss_j = jm.forward_text(params, text)
    np.testing.assert_allclose(float(tm.forward_text(text)), float(loss_j), atol=1e-4)
    assert float(tm(torch.as_tensor(text))) == float(tm.forward_text(text))


@pytest.mark.parametrize("channel_first", [False, True])
def test_forward_modality_matches_jax(params, channel_first):
    """The flow at given times and the flow loss on JAX's draws (its key
    split into uniform times and normal noise), within 1e-4."""
    jm, tm = pair(params, "dense", channel_first_latent=channel_first)
    lat = np.random.default_rng(1).standard_normal((3, 4, 16)).astype(np.float32)
    if channel_first:
        lat = np.moveaxis(lat, -1, 1)
    times = np.asarray([0.1, 0.5, 0.9], np.float32)
    flow_j = jm.forward_modality(params, lat, times=times, return_loss=False)
    flow_t = tm.forward_modality(lat, times=times, return_loss=False)
    assert flow_t.shape == lat.shape
    np.testing.assert_allclose(flow_t.numpy(), np.asarray(flow_j), atol=1e-4)

    rng = jax.random.PRNGKey(5)
    rng_t, rng_n = jax.random.split(rng)
    t_draw = np.asarray(jax.random.uniform(rng_t, (3,)))
    n_draw = np.asarray(jax.random.normal(rng_n, (3, 4, 16)))  # channel-last, as JAX draws it
    loss_j, parts_j = jm.forward_modality(params, lat, rng=rng, return_loss_breakdown=True)
    loss_t, parts_t = tm.forward_modality(lat, times=t_draw, noise=n_draw,
                                          return_loss_breakdown=True)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-4)
    np.testing.assert_allclose(float(parts_t[0]), float(parts_j[0]), atol=1e-4)
    call = tm(lat, times=t_draw, noise=n_draw)
    assert float(call) == float(loss_t)


def test_forward_dispatches_samples_to_the_joint_loss(params):
    _, tm = pair(params, "dense")
    batch = [[np.asarray([1, 2, 3], np.int32), np.ones((4, 16), np.float32)]]
    a = tm(batch, generator=torch.Generator().manual_seed(0))
    b = tm.loss(batch, generator=torch.Generator().manual_seed(0))
    assert float(a) == float(b)
    # the velocity term (which raised before the modality I/O slice): the
    # JAX loss on its own draws, the EMA model here being the model itself
    jm, _ = pair(params, "dense")
    lat = np.random.default_rng(3).standard_normal((2, 4, 16)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    rng_t, rng_n = jax.random.split(rng)
    loss_j, parts_j = jm.forward_modality(params, lat, rng=rng, return_loss_breakdown=True,
                                          velocity_consistency_ema_params=params)
    ema = {k: v.clone() for k, v in tm.core.named_parameters()}
    loss_t, parts_t = tm.forward_modality(
        lat, times=np.asarray(jax.random.uniform(rng_t, (2,))),
        noise=np.asarray(jax.random.normal(rng_n, (2, 4, 16))), return_loss_breakdown=True,
        velocity_consistency_ema_params=ema)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-4)
    np.testing.assert_allclose([float(x) for x in parts_t], [float(x) for x in parts_j],
                               atol=1e-4)
    assert float(parts_t[1]) > 0


@pytest.mark.parametrize("method", ["midpoint", "adaptive"])
def test_generate_modality_only_matches_jax(params, method):
    """JAX's noise (its normal draw under rng) fed to the port: latents
    within 1e-3; the channel-first model returns the same latents moved to
    channels first."""
    jm, tm = pair(params, "dense", odeint_method=method)
    rng = jax.random.PRNGKey(2)
    out_j = jm.generate_modality_only(params, batch_size=2, rng=rng, modality_steps=4,
                                      fixed_modality_shape=(3,))
    noise = np.asarray(jax.random.normal(rng, (2, 3, 16)))
    out_t = tm.generate_modality_only(noise=noise, modality_steps=4)
    assert out_t.shape == (2, 3, 16)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-3)
    if method == "midpoint":
        _, cf = pair(params, "dense", channel_first_latent=True)
        out_cf = cf.generate_modality_only(noise=noise, modality_steps=4)
        assert torch.equal(out_cf, out_t.movedim(-1, 1))
        drawn = tm.generate_modality_only(batch_size=2, generator=torch.Generator().manual_seed(0))
        assert drawn.shape == (2, 4, 16) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_uncached_sample_matches_jax(params, attn_impl, cfg_scale):
    """Greedy text, injected noise: the same token stream, latents within
    1e-3, through text, a modality segment and text again."""
    jm, tm = pair(params, attn_impl)
    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, 2, jm.som_ids[0]], np.int32)], max_length=8,
              modality_steps=4, init_modality_noise=noise, cfg_scale=cfg_scale,
              text_temperature=0.0)
    out_j = jm.sample(params, rng=jax.random.PRNGKey(1), return_unprocessed_modalities=True, **kw)
    out_t = tm.sample(**kw)
    assert sum(isinstance(o, tuple) for o in out_t) == 1
    assert_items(out_t, out_j)


def test_uncached_sample_matches_cached(params):
    """The port's uncached and KV-cached loops give the same tokens and
    latents within 2e-3 (the counterpart of
    tests/test_cached_sampling.py::test_cached_sample_matches_uncached_modality)."""
    _, tm = pair(params, "flash")
    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    kw = dict(prompt=[np.asarray([tm.som_ids[0]])], max_length=10, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0)
    out_a = tm.sample(cache_kv=False, **kw)
    out_b = tm.sample(cache_kv=True, **kw)
    assert_items(out_a, out_b, atol=2e-3)


@pytest.mark.parametrize("max_length", [0, 3])
def test_uncached_sample_stops_at_max_length_and_eos(params, max_length):
    """max_length bounds the sampled length (a text prompt: greedy tokens
    equal to JAX's); sampled text stays in the vocabulary."""
    jm, tm = pair(params, "dense")
    kw = dict(prompt=[np.asarray([1, 2, 3], np.int32)], max_length=max_length,
              text_temperature=0.0, cfg_scale=3.0)
    out_j = jm.sample(params, rng=jax.random.PRNGKey(1), return_unprocessed_modalities=True, **kw)
    out_t = tm.sample(**kw)
    assert_items(out_t, out_j)
    sampled = tm.sample(generator=torch.Generator().manual_seed(3), max_length=max_length,
                        prompt=[np.asarray([1, 2, 3], np.int32)], text_temperature=1.0,
                        modality_steps=2)
    text = np.concatenate([o for o in sampled if not isinstance(o, tuple)])
    assert ((text >= 0) & (text < tm.vocab_size)).all()


def test_sample_without_text_vocabulary_generates_a_modality(params):
    """num_text_tokens == 0: sample() forwards to generate_modality_only."""
    tm = Transfusion(transformer=tcfg("dense"), device="cpu",
                     **dict(CFG, num_text_tokens=0))
    a = tm.sample(generator=torch.Generator().manual_seed(1))
    b = tm.generate_modality_only(generator=torch.Generator().manual_seed(1))
    assert a.shape == (1, 4, 16) and torch.equal(a, b)
