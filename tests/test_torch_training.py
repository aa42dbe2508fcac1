"""PyTorch port: the joint training step against the JAX package on the
CPU, in float32: the shift-friendly packer, the joint loss and every
parameter gradient (same weights through `weights.from_flax`, same random
draws made from the JAX key schedule of `transfusion.py:884-910` and handed
over as numpy), three `Trainer` steps with the fused clip + Adam + EMA
update, the EMA schedule, and a checkpoint round trip.

Two model configurations: dim 64 with 2 heads x 64, whose attention takes
the token-major route (`nhd_eligible`), and dim 32 with 2 heads x 32, which
takes the head-major route. Tolerance 1e-4 for losses and gradients (sums
of a few thousand float32 products in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.models.transfusion import default_modality_times as j_default_times
from transfusion_tpu.training.ema import ema_update as j_ema_update
from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.transfusion import LossDraws, default_modality_times
from transfusion_tpu_torch.ops.flash_attn_nhd import nhd_eligible
from transfusion_tpu_torch.training import Trainer, ema_update, init_ema
from transfusion_tpu_torch.weights import from_flax

torch.set_num_threads(1)

CFG = dict(num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4), pad_multiple=16,
           prob_uncond=0.5)
TCFG = {
    "token-major": dict(dim=64, depth=2, dim_head=64, heads=2, attn_impl="flash"),
    "head-major": dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="flash"),
}


def jitter(params, seed=42, scale=0.05):
    """Break the zero-init symmetry so every branch carries signal."""
    key = jax.random.PRNGKey(seed)

    def f(path, p):
        nonlocal key
        key, k = jax.random.split(key)
        return p + jax.random.normal(k, p.shape) * scale

    return jax.tree_util.tree_map_with_path(f, params)


def samples(seed=0):
    """Three samples: text + a 4x4 latent + text, text only, and a 2x4
    latent alone (two latent groups of one modality type)."""
    rng = np.random.default_rng(seed)
    return [
        [rng.integers(0, 16, 5).astype(np.int32),
         (0, rng.standard_normal((4, 4, 8)).astype(np.float32)),
         rng.integers(0, 16, 3).astype(np.int32)],
        [rng.integers(0, 16, 9).astype(np.int32)],
        [(0, rng.standard_normal((2, 4, 8)).astype(np.float32))],
    ]


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def draws_from_key(rng, packed):
    """The JAX `_loss_impl` draws for key `rng`, as (LossDraws, uniforms)."""
    b, m = packed.spans.shape[:2]
    rng_times, rng_cfg, rng_noise, _ = jax.random.split(rng, 4)
    r1, r2 = jax.random.split(rng_times)
    u1, u2 = jax.random.uniform(r1, (b,)), jax.random.uniform(r2, (b,))
    num_mods = jnp.asarray((packed.spans[..., 2] > 0).sum(-1))
    keys = jax.random.split(rng_noise, max(len(packed.groups), 1))
    noises = tuple(torch.tensor(np.asarray(jax.random.normal(keys[i], g.latents.shape)))
                   for i, g in enumerate(packed.groups))
    times = default_modality_times(torch.tensor(np.asarray(u1)), torch.tensor(np.asarray(u2)),
                                   torch.tensor(np.asarray(num_mods)), m)
    np.testing.assert_array_equal(times.numpy(),
                                  np.asarray(j_default_times(rng_times, num_mods, m)))
    cfg_u = torch.tensor(np.asarray(jax.random.uniform(rng_cfg, (b,))))
    return LossDraws(times=times, cfg_uniform=cfg_u, noises=noises)


def init_params(route, seed=0):
    """Jittered JAX params for the route's config, initialized (jitted)
    through the dense twin: the same tree, without the Pallas kernels in
    interpret mode, so it is cheaper on the CPU."""
    dense = JaxTransfusion(transformer=dict(TCFG[route], attn_impl="dense"), **CFG)
    init = jax.jit(lambda key: dense.core.init(key, method="init_all"))
    return jitter(init(jax.random.PRNGKey(seed)))


def core_params(tm, tree):
    """A flax tree (params or grads) as the port's parameter dict."""
    sd = from_flax(np_tree(tree), tm)
    return {k: sd[k] for k, _ in tm.core.named_parameters()}


@pytest.fixture(scope="module", params=list(TCFG))
def pair(request):
    jm = JaxTransfusion(transformer=TCFG[request.param], **CFG)
    params = init_params(request.param)
    tm = Transfusion(transformer=TCFG[request.param], device="cpu", **CFG)
    tm.load_flax(np_tree(params))
    return request.param, jm, params, tm


def test_shift_friendly_pack_matches_jax():
    jm = JaxTransfusion(transformer=TCFG["head-major"], **CFG)
    tm = Transfusion(transformer=TCFG["head-major"], device="cpu", **CFG)
    for shift in (False, True):
        pj = jm.pack(samples(), shift_friendly=shift)
        pt = tm.pack(samples(), shift_friendly=shift)
        assert pt.text.shape[1] == (49 if shift else 48)
        for f in ("text", "cfg_mask", "spans", "lengths", "total_tokens"):
            np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)), err_msg=f)
        assert len(pt.groups) == len(pj.groups) == 2
        for gt, gj in zip(pt.groups, pj.groups):
            for f in ("latents", "batch_idx", "offsets", "span_rows"):
                np.testing.assert_array_equal(getattr(gt, f), np.asarray(getattr(gj, f)))
            assert gt.seq_shape == gj.seq_shape
    with pytest.raises(ValueError, match="shift slot"):
        tm.pack(samples(), shift_friendly=True, pad_len=32)


def test_joint_loss_and_grads_match_jax(pair):
    route, jm, params, tm = pair
    packed = jm.pack(samples(), shift_friendly=True)
    n = packed.text.shape[1] - 1
    assert nhd_eligible(2, n, TCFG[route]["dim_head"]) == (route == "token-major")
    rng = jax.random.PRNGKey(7)
    draws = draws_from_key(rng, packed)
    assert bool((draws.cfg_uniform < 0.5).any()), "no sample's text was dropped"

    def jloss(p):
        return jm._loss_impl(p, jax.tree.map(jnp.asarray, packed), rng, None, None,
                             prob_uncond=0.5, velocity_delta=1e-3, train=True)

    (total_j, bd_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    leaves = {k: p.requires_grad_(True) for k, p in core_params(tm, params).items()}
    packed_t = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    total_t, bd_t = tm._loss_impl(leaves, packed_t, draws, 0.5, train=True)
    grads_t = torch.autograd.grad(total_t, list(leaves.values()), allow_unused=True)

    np.testing.assert_allclose(total_t.item(), float(total_j), atol=1e-4)
    np.testing.assert_allclose(bd_t.text.item(), float(bd_j.text), atol=1e-4)
    assert len(bd_t.flow) == len(bd_j.flow) == 1
    np.testing.assert_allclose(bd_t.flow[0].item(), float(bd_j.flow[0]), atol=1e-4)
    want = core_params(tm, grads_j)
    for (k, _), g in zip(leaves.items(), grads_t):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)


def test_trainer_steps_match_jax(tmp_path):
    """Three steps of the port's Trainer against the JAX Trainer with its
    fused clip + Adam + EMA update (lr 1e-3, EMA from step 2 with beta 0.9,
    so warm-up copy and blend are both crossed)."""
    jm = JaxTransfusion(transformer=TCFG["token-major"], **CFG)
    tm = Transfusion(transformer=TCFG["token-major"], device="cpu", **CFG)
    kw = dict(learning_rate=1e-3, ema_beta=0.9, ema_update_every=1, ema_update_after_step=1)
    jtr = JaxTrainer(jm, **kw)
    params = init_params("token-major", seed=1)
    state_j = JaxTrainState(params=params, opt_state=jtr.tx.init(params),
                            ema=j_init_ema(params), step=jnp.zeros((), jnp.int32))
    tm.load_flax(np_tree(params))  # also carries the fixed time-embedding frequencies
    ttr = Trainer(tm, checkpoint_dir=str(tmp_path), **kw)
    state_t = ttr.init_state(core_params(tm, params))

    packed = jm.pack(samples(1), shift_friendly=True)
    packed_j = jax.tree.map(jnp.asarray, packed)
    packed_t = tm.pack(samples(1), shift_friendly=True).to_torch("cpu")
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        state_j, met_j = jtr.train_step(state_j, packed_j, rng)
        state_t, met_t = ttr.train_step(state_t, packed_t, draws=draws_from_key(rng, packed))
        for key in ("loss", "text_loss", "flow_loss_0"):
            np.testing.assert_allclose(float(met_t[key]), float(met_j[key]), atol=2e-4,
                                       err_msg=f"step {i} {key}")
        # the norm of ~40k float32 gradients summed in another order
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]),
                                   rtol=1e-4)
    assert state_t.step == int(state_j.step) == 3 and state_t.ema.step == 3
    # Not 1e-6: Adam divides by sqrt(nu), so an entry whose gradient is ~0
    # (a few 1e-9, summed in another order on the two sides) takes a step
    # of up to lr whose size and sign rest on rounding. Bound: 0.1 lr after
    # 3 steps (measured 2.3e-5 = 0.023 lr, on 0.006 % of the entries).
    lr = kw["learning_rate"]
    for name, tree, got in (("params", state_j.params, state_t.params),
                            ("ema", state_j.ema.params, state_t.ema.params)):
        want = core_params(tm, tree)
        diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
        assert diffs.max().item() <= 0.1 * lr, name

    # checkpoint round trip: the restored state takes the same next step
    ttr.save(state_t)
    restored = ttr.restore()
    adam_t, adam_r = state_t.opt_state[1], restored.opt_state[1]  # (clip, adam)
    assert restored.step == 3 and adam_r["count"] == 3 and restored.ema.step == 3
    for a, b in ((restored.params, state_t.params), (adam_r["nu"], adam_t["nu"]),
                 (restored.ema.params, state_t.ema.params)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    draws = draws_from_key(jax.random.PRNGKey(9), packed)
    _, m1 = ttr.train_step(state_t, packed_t, draws=draws)
    _, m2 = ttr.train_step(restored, packed_t, draws=draws)
    assert float(m1["loss"]) == float(m2["loss"])
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    # the trained weights reach the serving modules
    ttr.sync_model(restored)
    assert all(torch.equal(p, restored.params[k]) for k, p in tm.core.named_parameters())


def test_train_steps_cycle_batches_like_jax(monkeypatch):
    """`Trainer.train_steps` over a list of two packed batches and 4 steps
    against the JAX scan (step i takes batches[i % 2], its draws from the
    i-th split of the key), float32: parameters within 1e-4. Batches of
    different packed structures are refused on both sides."""
    jm = JaxTransfusion(transformer=TCFG["token-major"], **CFG)
    tm = Transfusion(transformer=TCFG["token-major"], device="cpu", **CFG)
    kw = dict(learning_rate=1e-3, ema_beta=0.9, ema_update_every=1, ema_update_after_step=1)
    jtr = JaxTrainer(jm, **kw)
    params = init_params("token-major", seed=4)
    state_j = JaxTrainState(params=params, opt_state=jtr.tx.init(params),
                            ema=j_init_ema(params), step=jnp.zeros((), jnp.int32))
    tm.load_flax(np_tree(params))
    ttr = Trainer(tm, **kw)
    state_t = ttr.init_state(core_params(tm, params))

    packs = [jm.pack(samples(seed), shift_friendly=True) for seed in (1, 2)]
    rng = jax.random.PRNGKey(11)
    state_j, met_j = jtr.train_steps(state_j, [jax.tree.map(jnp.asarray, p) for p in packs],
                                     rng, 4)
    schedule, key = [], rng
    for i in range(4):
        key, k = jax.random.split(key)
        schedule.append(draws_from_key(k, packs[i % 2]))
    monkeypatch.setattr(tm, "make_draws", lambda packed, generator=None, velocity=False:
                        schedule.pop(0))
    state_t, met_t = ttr.train_steps(
        state_t, [tm.pack(samples(seed), shift_friendly=True) for seed in (1, 2)], 4)
    assert not schedule and state_t.step == int(state_j.step) == 4
    np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]), atol=2e-4)
    for name, tree, got in (("params", state_j.params, state_t.params),
                            ("ema", state_j.ema.params, state_t.ema.params)):
        want = core_params(tm, tree)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-4,
                                       err_msg=f"{name} {k}")

    other = tm.pack(samples(1)[:2], shift_friendly=True)
    with pytest.raises(ValueError, match="one packed structure"):
        ttr.train_steps(state_t, [tm.pack(samples(1), shift_friendly=True), other], 2)
    with pytest.raises(ValueError, match="one packed structure"):
        jtr.train_steps(state_j, [jax.tree.map(jnp.asarray, packs[0]),
                                  jax.tree.map(jnp.asarray, jm.pack(samples(1)[:2],
                                                                    shift_friendly=True))],
                        rng, 2)


def test_ema_schedule_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    st_j, st_t = j_init_ema(jax.tree.map(jnp.asarray, tree)), init_ema(
        {k: torch.tensor(v) for k, v in tree.items()})
    for step in range(7):
        new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
        kw = dict(beta=0.8, update_every=2, update_after_step=3)
        st_j = j_ema_update(st_j, jax.tree.map(jnp.asarray, new), **kw)
        st_t = ema_update(st_t, {k: torch.tensor(v) for k, v in new.items()}, **kw)
        for k in tree:
            np.testing.assert_allclose(st_t.params[k].numpy(), np.asarray(st_j.params[k]),
                                       atol=1e-6, err_msg=f"step {step} {k}")
    assert st_t.step == int(st_j.step) == 7


def test_unported_training_options_raise():
    """The pipeline (ported since; tests/test_torch_pipeline*.py) needs a
    mesh with a 'pipe' axis, as in JAX, and the mesh, which raised before
    the parallelism slice, takes a `parallel.make_mesh` mesh and refuses
    anything else (tests/test_torch_distributed.py holds it against JAX);
    so does a dropout model's training step (refused as in JAX; dropout
    raised at construction before the single-process surface slice). The velocity and
    reconstruction options (which raised before the modality I/O slice)
    now give the JAX loss: `loss(velocity_consistency_ema_params=)` on a
    model with `reconstruction_loss_weight`, its breakdown within 1e-4, and
    `Trainer(velocity_consistency=True)` builds."""
    tm = Transfusion(transformer=TCFG["head-major"], device="cpu", **CFG)
    for kw, err, match in ((dict(pipeline_microbatches=2), ValueError,
                            "needs a mesh with a 'pipe' axis"),
                           (dict(mesh=object()), TypeError, "make_mesh")):
        with pytest.raises(err, match=match):
            Trainer(tm, **kw)
    dm = Transfusion(transformer=dict(TCFG["head-major"], dropout=0.1), device="cpu", **CFG)
    with pytest.raises(ValueError, match="needs PRNG"):
        Trainer(dm).train_step(Trainer(dm).init_state(), samples(), generator=torch.Generator())
    assert Trainer(tm, velocity_consistency=True).velocity_consistency
    jm = JaxTransfusion(transformer=dict(TCFG["head-major"], attn_impl="dense"),
                        reconstruction_loss_weight=0.1, **CFG)
    params = init_params("head-major", seed=2)
    # EMA weights a little away from the model's; the fourier frequencies
    # are frozen in both packages, so the EMA holds the model's
    ema = jax.tree_util.tree_map_with_path(
        lambda path, e, p: p if "fourier_weights" in jax.tree_util.keystr(path) else e,
        jitter(params, seed=9, scale=0.02), params)
    tm = Transfusion(transformer=TCFG["head-major"], reconstruction_loss_weight=0.1,
                     device="cpu", **CFG)
    tm.load_flax(np_tree(params))
    rng = jax.random.PRNGKey(3)
    packed = jm.pack(samples(), shift_friendly=True)
    total_j, bd_j = jm.loss(params, samples(), rng, velocity_consistency_ema_params=ema,
                            prob_uncond=0.5, return_breakdown=True)
    draws = draws_from_key(rng, packed)
    keys = jax.random.split(jax.random.split(rng, 4)[3], len(packed.groups))
    draws = dataclasses.replace(draws, ema_noises=tuple(
        torch.tensor(np.asarray(jax.random.normal(k, g.latents.shape)))
        for k, g in zip(keys, packed.groups)))
    total_t, bd_t = tm.loss(samples(), draws, velocity_consistency_ema_params=core_params(
        tm, ema), prob_uncond=0.5, return_breakdown=True)
    np.testing.assert_allclose(total_t.item(), float(total_j), atol=1e-4)
    for name in ("text", "flow", "velocity", "recon"):
        np.testing.assert_allclose(np.asarray(getattr(bd_t, name), np.float64),
                                   np.asarray(getattr(bd_j, name), np.float64), atol=1e-4,
                                   err_msg=name)
