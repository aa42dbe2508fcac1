"""PyTorch port: module-level dropout against flax on the CPU, in float32.

flax's `nn.Dropout` draws `jax.random.bernoulli(rng, 1 - rate, shape)`
and selects x / (1 - rate). The tests record those masks (the JAX core
applied un-jitted, with `deterministic=False` and a 'dropout' rng; the
draws come block by block, attention before feedforward) and hand the same
masks to the port's core, whose outputs and parameter gradients must agree
within 1e-4. They also hold the port's own corners against JAX: the flash
route drops no attention probabilities, remat recomputes with the same
masks, inference and `loss(train=False)` ignore dropout, and
`loss(train=True)` with dropout is refused, as flax refuses it for want of
a 'dropout' rng."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import core_params, jitter, np_tree

from transfusion_tpu.models.layers import FeedForward as JaxFeedForward
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.layers import FeedForward
from transfusion_tpu_torch.training import Trainer

torch.set_num_threads(1)

RATE = 0.1
CFG = dict(num_text_tokens=16, dim_latent=4, modality_default_shape=(2, 2), pad_multiple=16)


def tcfg(**kw):
    return dict(dim=32, depth=2, heads=2, dim_head=16, dropout=RATE, **kw)


def samples(seed=0):
    rng = np.random.default_rng(seed)
    return [
        [rng.integers(0, 16, 5).astype(np.int32),
         (0, rng.standard_normal((2, 2, 4)).astype(np.float32)),
         rng.integers(0, 16, 3).astype(np.int32)],
        [rng.integers(0, 16, 7).astype(np.int32)],
    ]


@pytest.fixture
def recorder(monkeypatch):
    """Record every mask flax's dropout draws outside a trace."""
    masks, bernoulli = [], jax.random.bernoulli

    def record(key, p=0.5, shape=None, *args, **kw):
        m = bernoulli(key, p, shape, *args, **kw)
        if not isinstance(m, jax.core.Tracer):
            masks.append(torch.tensor(np.asarray(m)))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", record)
    return masks


def pair(**kw):
    jm = JaxTransfusion(transformer=tcfg(**kw), **CFG)
    params = jitter(jm.init_params(jax.random.PRNGKey(0)))
    tm = Transfusion(transformer=tcfg(**kw), device="cpu", **CFG)
    tm.load_flax(np_tree(params))
    return jm, params, tm


def jax_joint(jm, params, packed, times, rngs):
    return jm.core.apply(params, jax.tree.map(jnp.asarray, packed), jnp.asarray(times),
                         deterministic=False, rngs=rngs, method="joint")


def block_masks(masks, depth, attn=True):
    """The recorded masks as the port's per-block {'attn', 'ff'} dicts."""
    per = 2 if attn else 1
    assert len(masks) == per * depth, [tuple(m.shape) for m in masks]
    return [{"attn": masks[per * i] if attn else None, "ff": masks[per * i + per - 1]}
            for i in range(depth)]


@pytest.mark.parametrize("rate", [RATE, 1.0])
def test_feedforward_dropout_matches_flax(recorder, rate):
    ff_j = JaxFeedForward(dim=32, dropout=rate)
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    params = jitter(ff_j.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    with jax.disable_jit():
        want = ff_j.apply(params, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(3)})
    ff_t = FeedForward(32, dropout=rate)
    p = params["params"]
    ff_t.load_state_dict({f"{m}.{w}": torch.tensor(np.asarray(p[m][k])).T if k == "kernel"
                          else torch.tensor(np.asarray(p[m][k]))
                          for m in ("proj_in", "proj_out") for k, w in (("kernel", "weight"),
                                                                       ("bias", "bias"))})
    mask = recorder[0] if recorder else torch.zeros((2, 5, ff_t.dim_inner), dtype=torch.bool)
    assert len(recorder) == (1 if rate < 1 else 0)  # flax draws nothing at rate 1
    got = ff_t(torch.tensor(x), dropout_mask=mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(ff_t(torch.tensor(x)).detach().numpy(), np.asarray(
        ff_j.apply(params, jnp.asarray(x))), atol=1e-5)  # no mask: deterministic


@pytest.mark.parametrize("laser", [False, True])
def test_joint_dropout_and_grads_match_flax(recorder, laser):
    """The dense route: feedforward and attention-probability dropout, with
    LASER and without; logits, flows and every gradient within 1e-4."""
    jm, params, tm = pair(attn_laser=laser)
    packed = jm.pack(samples(), shift_friendly=True)
    times = np.full(packed.spans.shape[:2], 0.3, np.float32)
    rngs = {"dropout": jax.random.PRNGKey(1)}
    with jax.disable_jit():
        j_logits, _, j_flows, _, _ = jax_joint(jm, params, packed, times, rngs)
    masks = block_masks(recorder, 2)
    n = packed.text.shape[1]
    assert masks[0]["attn"].shape == (2, 2, n, n)
    assert 0.8 < float(masks[0]["ff"].float().mean()) < 0.97

    # random cotangents scaled so that the gradients are O(1)
    w_logits = np.random.default_rng(2).standard_normal(j_logits.shape).astype(np.float32)
    w_flow = np.random.default_rng(3).standard_normal(j_flows[0].shape).astype(np.float32)
    w_logits /= w_logits.size ** 0.5
    w_flow /= w_flow.size ** 0.5

    def jscore(p):
        logits, _, flows, _, _ = jax_joint(jm, p, packed, times, rngs)
        return (logits * w_logits).sum() + (flows[0] * w_flow).sum()

    grads_j = jax.jit(jax.grad(jscore))(params)

    leaves = {k: p.requires_grad_(True) for k, p in core_params(tm, params).items()}
    packed_t = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    logits, _, flows, _, _ = torch.func.functional_call(
        tm.core, leaves, (packed_t, torch.tensor(times)), {"dropout": masks})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(flows[0].detach().numpy(), np.asarray(j_flows[0]), atol=1e-4)
    score = (logits * torch.tensor(w_logits)).sum() + (flows[0] * torch.tensor(w_flow)).sum()
    grads_t = torch.autograd.grad(score, list(leaves.values()), allow_unused=True)
    want = core_params(tm, grads_j)
    for k, g in zip(leaves, grads_t):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    # without masks the core is deterministic: flax's deterministic=True
    det = jm.core.apply(params, jax.tree.map(jnp.asarray, packed), jnp.asarray(times),
                        method="joint")[0]
    np.testing.assert_allclose(tm.core.joint(packed_t, torch.tensor(times))[0].numpy(),
                               np.asarray(det), atol=1e-4)


def test_remat_recomputes_with_the_same_masks():
    """Masks drawn from a generator, with remat: the same gradients as the
    same draws without remat (the recomputed forward reuses them)."""
    grads = []
    for remat in (False, True):
        tm = Transfusion(transformer=tcfg(remat=remat), device="cpu", seed=3, **CFG)
        leaves = {k: p.detach().clone().requires_grad_(True)
                  for k, p in tm.core.named_parameters()}
        packed = tm.pack(samples(1), shift_friendly=True).to_torch("cpu")
        times = torch.full(packed.spans.shape[:2], 0.6)
        logits, _, flows, _, _ = torch.func.functional_call(
            tm.core, leaves, (packed, times), {"dropout": torch.Generator().manual_seed(5)})
        score = logits.square().mean() + flows[0].square().mean()
        grads.append(torch.autograd.grad(score, list(leaves.values()), allow_unused=True))
    for k, a, b in zip(leaves, *grads):
        assert (a is None) == (b is None), k
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


def test_flash_route_applies_no_attention_dropout(recorder):
    """On the flash route flax draws only the feedforward masks; the port
    given them (or a generator) drops no attention probabilities either,
    also on the dense path that the flash spec takes at this head width
    (16, which the kernel does not take)."""
    jm, params, tm = pair(attn_impl="flash")
    packed = jm.pack(samples(), shift_friendly=True)
    times = np.full(packed.spans.shape[:2], 0.3, np.float32)
    with jax.disable_jit():
        j_logits, _, j_flows, _, _ = jax_joint(jm, params, packed, times,
                                               {"dropout": jax.random.PRNGKey(1)})
    masks = block_masks(recorder, 2, attn=False)
    packed_t = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    logits, _, flows, _, _ = tm.core.joint(packed_t, torch.tensor(times), dropout=masks)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(flows[0].numpy(), np.asarray(j_flows[0]), atol=1e-4)
    n = packed.text.shape[1]
    drop_all = [dict(m, attn=torch.zeros((2, 2, n, n), dtype=torch.bool)) for m in masks]
    assert torch.equal(tm.core.joint(packed_t, torch.tensor(times), dropout=drop_all)[0], logits)
    drawn = tm.core.transformer.draw_dropout_masks(torch.Generator(), 2, n,
                                                   spans=packed_t.spans)
    assert all(m["attn"] is None and m["ff"].shape == (2, n, 85) for m in drawn)


def test_inference_and_eval_loss_ignore_dropout():
    """A dropout model and its dropout-0 twin (same weights) give the same
    eval loss (equal to JAX's), text logits and cached sample."""
    jm, params, tm = pair()
    plain = Transfusion(transformer=dict(tcfg(), dropout=0.0), device="cpu", **CFG)
    plain.load_flax(np_tree(params))
    draws = tm.make_draws(tm.pack(samples(), wrap_sos_eos=True, add_meta=True,
                                  shift_friendly=True).to_torch("cpu"),
                          torch.Generator().manual_seed(0))
    losses = [m.loss(samples(), draws, train=False) for m in (tm, plain)]
    assert torch.equal(losses[0], losses[1])
    toks = np.asarray([[8, 1, 2, 3, 7, 5]], np.int32)
    assert torch.equal(tm.forward_text(toks, return_loss=False),
                       plain.forward_text(toks, return_loss=False))
    np.testing.assert_allclose(tm.forward_text(toks).item(),
                               float(jm.forward_text(params, toks)), atol=1e-5)
    noise = np.random.default_rng(4).standard_normal((4, 4)).astype(np.float32)
    outs = [m.sample(prompt=[np.asarray([1, m.som_ids[0]])], max_length=8, modality_steps=2,
                     text_temperature=0.0, init_modality_noise=noise, cache_kv=True)
            for m in (tm, plain)]
    for a, b in zip(*outs):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)


def test_train_loss_with_dropout_is_refused_as_in_jax():
    jm, params, tm = pair()
    with pytest.raises(flax.errors.InvalidRngError, match="needs PRNG"):
        jm.loss(params, samples(), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="needs PRNG for \"dropout\""):
        tm.loss(samples(), generator=torch.Generator().manual_seed(0))
    trainer = Trainer(tm)
    with pytest.raises(ValueError, match="train=False"):
        trainer.train_step(trainer.init_state(), samples(),
                           generator=torch.Generator().manual_seed(0))
