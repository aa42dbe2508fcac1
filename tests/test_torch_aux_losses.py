"""PyTorch port: the velocity-consistency and reconstruction losses against
the JAX package, float32 on the CPU, on the image model of
tests/test_torch_modality_io.py (patch encoder / decoder, U-Net halves,
axial position embedding, reconstruction weight 0.1):

  * `_loss_impl` with EMA parameters: the total, each velocity and
    reconstruction entry and every gradient (1e-4), the EMA forward's
    noise taken from JAX's `rng_noise_ema` split;
  * three `Trainer(velocity_consistency=True)` steps against the JAX
    `Trainer` (metrics 2e-4; parameters within 0.1 lr, as
    tests/test_torch_training.py);
  * `Trainer(grad_accumulation=2)` against the whole batch's step with the
    same draws, the reconstruction term's per-instance denominators
    (`inst_counts`) included;
  * `forward_modality` with the velocity term and the reconstruction
    through the decoder, and the zero gradient of its velocity term: the
    target is the true flow against the EMA flow, so no parameter reaches
    it (JAX `transfusion.py:1287-1290`, matched on purpose)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch.training import Trainer
from transfusion_tpu_torch.weights import from_flax

from test_torch_modality_io import images, jax_model, jitter, port_model, samples
from test_torch_training import draws_from_key

torch.set_num_threads(1)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def as_dict(tm, tree):
    """A flax tree (params, EMA params or grads) as the port's parameter dict."""
    sd = from_flax(np_tree(tree), tm)
    return {k: sd[k] for k, _ in tm.core.named_parameters()}


def draws_with_ema(rng, packed):
    """The JAX `_loss_impl` draws of key `rng`, with the EMA forward's noise
    from its fourth split (`rng_noise_ema`, one key per latent group)."""
    keys = jax.random.split(jax.random.split(rng, 4)[3], max(len(packed.groups), 1))
    ema = tuple(torch.tensor(np.asarray(jax.random.normal(keys[i], g.latents.shape)))
                for i, g in enumerate(packed.groups))
    return dataclasses.replace(draws_from_key(rng, packed), ema_noises=ema)


def ema_like(params, seed=43):
    """EMA parameters a little away from `params`. The time embedding's
    fourier frequencies stay as they are: both packages hold them frozen,
    so an EMA copy of them never moves (the port keeps them as a buffer,
    outside any parameter dict)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, e, p: p if "fourier_weights" in jax.tree_util.keystr(path) else e,
        jitter(params, seed=seed, scale=0.02), params)


@pytest.fixture(scope="module")
def models():
    jm = jax_model()
    params = jitter(jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, ema_like(params), port_model(params)


def test_joint_loss_with_velocity_and_recon_matches_jax(models):
    jm, params, ema, tm = models
    packed = jm.pack(jm.encode_modalities(samples()), shift_friendly=True)
    rng = jax.random.PRNGKey(3)  # times 0.38 and 0.13 (see test_torch_modality_io.py)

    def jloss(p):
        return jm._loss_impl(p, jax.tree.map(jnp.asarray, packed), rng, None, ema,
                             prob_uncond=0.5, velocity_delta=1e-3, train=True)

    (total_j, bd_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    leaves = {k: p.requires_grad_(True) for k, p in as_dict(tm, params).items()}
    packed_t = tm.pack(tm.encode_modalities(samples()), shift_friendly=True).to_torch("cpu")
    total_t, bd_t = tm._loss_impl(leaves, packed_t, draws_with_ema(rng, packed), 0.5,
                                  ema_params=as_dict(tm, ema), velocity_delta=1e-3)
    grads_t = torch.autograd.grad(total_t, list(leaves.values()))
    np.testing.assert_allclose(total_t.item(), float(total_j), atol=1e-4)
    for name in ("flow", "velocity", "recon"):
        got, want = getattr(bd_t, name), getattr(bd_j, name)
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0].item(), float(want[0]), atol=1e-4, err_msg=name)
    assert bd_t.velocity[0].item() > 1e-3 and bd_t.recon[0].item() > 1e-3
    want = as_dict(tm, grads_j)
    for k, g in zip(leaves, grads_t):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    # the draws must carry the EMA forward's noise
    with pytest.raises(ValueError, match="ema_noises"):
        tm._loss_impl(leaves, packed_t, draws_from_key(rng, packed), 0.5,
                      ema_params=as_dict(tm, ema))


def test_velocity_trainer_steps_match_jax():
    """Three steps of Trainer(velocity_consistency=True) (lr 1e-3, EMA from
    step 2 with beta 0.9), whose velocity target is the state's EMA."""
    jm = jax_model()
    params = jitter(jm.init_params(jax.random.PRNGKey(1)))
    tm = port_model(params)
    kw = dict(learning_rate=1e-3, ema_beta=0.9, ema_update_every=1, ema_update_after_step=1,
              velocity_consistency=True)
    jtr, ttr = JaxTrainer(jm, **kw), Trainer(tm, **kw)
    state_j = JaxTrainState(params=params, opt_state=jtr.tx.init(params),
                            ema=j_init_ema(params), step=jnp.zeros((), jnp.int32))
    state_t = ttr.init_state(as_dict(tm, params))
    packed = jm.pack(jm.encode_modalities(samples(1)), shift_friendly=True)
    packed_j = jax.tree.map(jnp.asarray, packed)
    packed_t = tm.pack(tm.encode_modalities(samples(1)), shift_friendly=True).to_torch("cpu")
    for i, key in enumerate((3, 4, 11)):  # times away from 1 (see above)
        rng = jax.random.PRNGKey(key)
        state_j, met_j = jtr.train_step(state_j, packed_j, rng)
        state_t, met_t = ttr.train_step(state_t, packed_t, draws=draws_with_ema(rng, packed))
        for name in ("loss", "text_loss", "flow_loss_0"):
            np.testing.assert_allclose(float(met_t[name]), float(met_j[name]), atol=2e-4,
                                       err_msg=f"step {i} {name}")
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]),
                                   rtol=1e-4)
        assert float(met_t["velocity_loss_0"]) > 0 and float(met_t["recon_loss_0"]) > 0
    lr = kw["learning_rate"]
    for name, tree, got in (("params", state_j.params, state_t.params),
                            ("ema", state_j.ema.params, state_t.ema.params)):
        want = as_dict(tm, tree)
        diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
        assert diffs.max().item() <= 0.1 * lr, name


def image_batch(n=4, seed=2):
    """n samples of [text][image][text] of ragged text lengths; one image
    shape, so the whole batch's latent group is the microbatches' groups
    one after the other."""
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 16, 3 + i).astype(np.int32), (0, images(rng, 1)[0]),
             rng.integers(0, 16, 2).astype(np.int32)] for i in range(n)]


def test_grad_accumulation_equals_whole_batch(models):
    """Trainer(grad_accumulation=2, velocity_consistency=True) on a ragged
    batch of raw images (each half encoded and packed on its own) against
    the whole batch's step, from the same draws: the reconstruction mean is
    per instance, so each microbatch divides by the whole batch's instance
    count."""
    _, params, _, tm = models
    kw = dict(learning_rate=1e-3, velocity_consistency=True)
    whole, accum = Trainer(tm, **kw), Trainer(tm, grad_accumulation=2, **kw)
    batch = image_batch()
    packs = accum._microbatches(batch)
    gen = torch.Generator().manual_seed(0)
    draws = [tm.make_draws(p, gen, velocity=True) for p in packs]
    packed = whole._packed(batch)
    assert [g.latents.shape[0] for p in packs for g in p.groups] == [2, 2]

    def cat(field):
        return torch.cat([getattr(d, field) if field in ("times", "cfg_uniform")
                          else getattr(d, field)[0] for d in draws])

    merged = dataclasses.replace(draws[0], times=cat("times"), cfg_uniform=cat("cfg_uniform"),
                                 noises=(cat("noises"),), ema_noises=(cat("ema_noises"),))
    s0, m0 = whole.train_step(whole.init_state(), packed, draws=merged)
    s1, m1 = accum.train_step(accum.init_state(), batch, draws=draws)
    assert set(m0) == set(m1) and "recon_loss_0" in m0 and "velocity_loss_0" in m0
    for key in m0:
        np.testing.assert_allclose(float(m1[key]), float(m0[key]), atol=1e-5, err_msg=key)
    lr = kw["learning_rate"]
    diffs = torch.cat([(s1.params[k] - s0.params[k]).abs().flatten() for k in s0.params])
    assert diffs.max().item() <= 0.1 * lr


def test_forward_modality_velocity_and_recon_match_jax(models):
    """Raw images through the encoder; the velocity term against the EMA's
    flow from the clean latents at t + delta; the reconstruction decoded
    back to images against the input. Loss, parts and every gradient within
    1e-4; neither the velocity term nor the decoded reconstruction carries
    a gradient (both sides)."""
    jm, params, ema, tm = models
    x = images(np.random.default_rng(6), 3)
    rng = jax.random.PRNGKey(3)  # times 0.009, 0.044, 0.312: a loss near 1 (see above)
    kw = dict(velocity_consistency_ema_params=ema, return_loss_breakdown=True)
    (total_j, parts_j), grads_j = jax.value_and_grad(
        lambda p: jm.forward_modality(p, x, rng=rng, **kw), has_aux=True)(params)
    vel_grads_j = jax.grad(lambda p: jm.forward_modality(p, x, rng=rng, **kw)[1][1])(params)
    assert all(float(jnp.abs(g).max()) == 0.0 for g in jax.tree.leaves(vel_grads_j))

    rng_t, rng_n = jax.random.split(rng)
    times = np.asarray(jax.random.uniform(rng_t, (3,)))
    noise = np.asarray(jax.random.normal(rng_n, (3, 6, 6, 8)))
    leaves = {k: p.requires_grad_(True) for k, p in as_dict(tm, params).items()}
    total_t, parts_t = tm.forward_modality(x, times=times, noise=noise, params=leaves,
                                           velocity_consistency_ema_params=as_dict(tm, ema),
                                           return_loss_breakdown=True)
    np.testing.assert_allclose(total_t.item(), float(total_j), atol=1e-4)
    for name, a, b in zip(("flow", "velocity", "recon"), parts_t, parts_j):
        np.testing.assert_allclose(a.item(), float(b), atol=1e-4, err_msg=name)
    assert parts_t[1].item() > 0 and parts_t[2].item() > 0
    assert not parts_t[1].requires_grad and not parts_t[2].requires_grad
    grads_t = torch.autograd.grad(total_t, list(leaves.values()), allow_unused=True)
    want = as_dict(tm, grads_j)
    for k, g in zip(leaves, grads_t):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
