"""PyTorch port: the transformer options of the example recipes against the
JAX package, float32 on the CPU: LASER attention on the token-major and
head-major flash routes and on the dense path (forward and every gradient),
`fuse_projections`, multi-stream hyper-connections, and a LASER + 4-stream
+ fused model through the joint loss (every gradient), cached `sample()`,
`generate_text_batch` and `plan_serving`. The JAX side runs its Pallas
kernels in interpret mode; the port runs its kernels' plain versions.

Tolerances: forwards 1e-5 and gradients 1e-4, of max(1, the reference's
largest element) (LASER's exp(v) reaches e^15, so its gradients are not of
order one); model losses and gradients 1e-4; sampled latents 1e-3; greedy
tokens equal."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import draws_from_key, jitter, np_tree
from transfusion_tpu.models.layers import Attention as JaxAttention
from transfusion_tpu.models.serving import plan_serving as jax_plan_serving
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.ops.hyper_connections import HyperConnection as JaxHyperConnection
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.layers import Attention
from transfusion_tpu_torch.models.serving import plan_serving
from transfusion_tpu_torch.ops import decode_attn
from transfusion_tpu_torch.ops.flash_attn_nhd import nhd_eligible
from transfusion_tpu_torch.ops.hyper_connections import (
    HyperConnection,
    expand_stream,
    reduce_stream,
)
from transfusion_tpu_torch.ops.rope import rope_angles
from transfusion_tpu_torch.weights import from_flax

torch.set_num_threads(1)

SPANS = np.asarray([[[0, 5, 20], [0, 40, 16]], [[0, 10, 0], [0, 30, 24]]], np.int32)
# route -> (attn_impl, heads, dim_head, n)
ROUTES = {"token-major": ("flash", 2, 64, 64), "head-major": ("flash", 2, 32, 40),
          "dense": ("dense", 2, 32, 40)}


def close(got, want, atol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def attention_pair(route, laser=True, fuse=False, v_scale=1.0, seed=0):
    """A JAX Attention (learned mix, gates) with seeded params, and the
    port's with the same weights; the V kernel scaled by v_scale."""
    impl, h, d, n = ROUTES[route]
    dim = 64
    jattn = JaxAttention(dim=dim, dim_head=d, heads=h, laser=laser,
                         learned_value_residual_mix=True, attn_impl=impl,
                         fuse_projections=fuse)
    # init takes the head-major route (no flash spec), whatever the route
    params = jattn.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, dim)),
                        value_residual=jnp.zeros((1, h, 8, d)))
    params = jitter(params, seed=seed + 1)
    p = params["params"]
    p = {**p, "to_v": {"kernel": p["to_v"]["kernel"] * v_scale}}
    params = {"params": p}
    tattn = Attention(dim, dim_head=d, heads=h, learned_value_residual_mix=True,
                      attn_impl=impl, laser=laser, fuse_projections=fuse)
    sd = {}
    for name, leaves in p.items():
        for leaf, arr in leaves.items():
            arr = np.asarray(arr)
            sd[f"{name}.{'weight' if leaf == 'kernel' else leaf}"] = torch.tensor(
                arr.T if leaf == "kernel" else arr)
    tattn.load_state_dict(sd)
    return jattn, params, tattn


def attention_inputs(route, seed=3):
    impl, h, d, n = ROUTES[route]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 64)).astype(np.float32)
    vr_shape = (2, n, h * d) if route == "token-major" else (2, h, n, d)
    vr = rng.standard_normal(vr_shape).astype(np.float32)
    go = rng.standard_normal((2, n, 64)).astype(np.float32)
    ang = rope_angles(torch.arange(n), d).numpy()
    spans = SPANS.copy()
    spans[..., 2] = np.minimum(spans[..., 2], n - spans[..., 1])
    mask = None
    if impl == "dense":
        seq = np.arange(n)
        mask = np.broadcast_to((seq[:, None] >= seq[None, :])[None, None], (2, 1, n, n))
    return x, vr, go, ang, spans, mask


@pytest.mark.parametrize("v_scale", [1.0, 8.0], ids=["v", "v_x8"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_laser_attention_matches_jax(route, v_scale):
    """LASER on each route: the output, the pre-exp values handed on as the
    value residual, and the gradients of x, the value residual and every
    weight. v_x8 drives softclamp(v, 15) toward its limit (exp(v) ~ 1e6)."""
    impl, h, d, n = ROUTES[route]
    assert nhd_eligible(h, n, d) == (route == "token-major")
    jattn, params, tattn = attention_pair(route, v_scale=v_scale)
    x, vr, go, ang, spans, mask = attention_inputs(route)
    flash_spec_j = None if impl == "dense" else {"spans": jnp.asarray(spans), "causal": True}
    flash_spec_t = None if impl == "dense" else {"spans": torch.tensor(spans), "causal": True}
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.tensor(mask)

    def jfn(p, x, vr):
        out, orig_v, _ = jattn.apply(p, x, mask=mask_j, rope=jnp.asarray(ang),
                                     value_residual=vr, flash_spec=flash_spec_j)
        return out, orig_v

    (out_j, orig_j), vjp = jax.vjp(jfn, params, jnp.asarray(x), jnp.asarray(vr))
    gp_j, gx_j, gvr_j = vjp((jnp.asarray(go), jnp.zeros_like(orig_j)))

    xt = torch.tensor(x, requires_grad=True)
    vrt = torch.tensor(vr, requires_grad=True)
    out_t, orig_t, _ = tattn(xt, mask=mask_t, rope=torch.tensor(ang), value_residual=vrt,
                             flash_spec=flash_spec_t)
    names = [k for k, _ in tattn.named_parameters()]
    grads = torch.autograd.grad((out_t * torch.tensor(go)).sum(),
                                [xt, vrt, *tattn.parameters()])
    close(out_t.detach().numpy(), out_j, 1e-5, "out")
    close(orig_t.detach().numpy(), orig_j, 1e-5, "orig_v")
    close(grads[0].numpy(), gx_j, 1e-4, "dx")
    close(grads[1].numpy(), gvr_j, 1e-4, "d value residual")
    for name, g in zip(names, grads[2:]):
        module, leaf = name.split(".")
        want = np.asarray(gp_j["params"][module]["kernel" if leaf == "weight" else leaf])
        close(g.numpy(), want.T if leaf == "weight" else want, 1e-4, name)


@pytest.mark.parametrize("route", list(ROUTES))
def test_fused_projections_equal_unfused(route):
    """fuse_projections runs the four projections as one product over the
    same parameters: output and gradients equal the unfused layer's within
    1e-5, and JAX's fused layer's."""
    impl, h, d, n = ROUTES[route]
    jattn, params, fused = attention_pair(route, laser=False, fuse=True)
    _, _, plain = attention_pair(route, laser=False, fuse=False)
    x, vr, go, ang, spans, mask = attention_inputs(route)
    spec = None if impl == "dense" else {"spans": torch.tensor(spans), "causal": True}
    mask_t = None if mask is None else torch.tensor(mask)
    outs = []
    for layer in (fused, plain):
        xt = torch.tensor(x, requires_grad=True)
        out = layer(xt, mask=mask_t, rope=torch.tensor(ang), value_residual=torch.tensor(vr),
                    flash_spec=spec)[0]
        outs.append([out.detach()] + list(torch.autograd.grad(
            (out * torch.tensor(go)).sum(), [xt, *layer.parameters()])))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    out_j = jattn.apply(params, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask),
                        rope=jnp.asarray(ang), value_residual=jnp.asarray(vr),
                        flash_spec=None if impl == "dense" else {
                            "spans": jnp.asarray(spans), "causal": True})[0]
    close(outs[0][0].numpy(), out_j, 1e-5, "fused vs JAX fused")


def test_hyper_connection_matches_jax():
    """Both phases at 4 streams and 4 fracs (dynamic weights on), against
    the JAX module with the same (jittered) parameters, and their
    gradients; the streams' mean; one stream equals the plain residual."""
    dim, streams, fracs = 32, 4, 4
    rng = np.random.default_rng(0)
    s = rng.standard_normal((streams, 2, 5, dim)).astype(np.float32)
    out = rng.standard_normal((2, 5, dim)).astype(np.float32)
    jhc = JaxHyperConnection(dim=dim, streams=streams, fracs=fracs, layer_index=3)
    params = jitter(jhc.init(jax.random.PRNGKey(0), jnp.asarray(s)), scale=0.3)
    thc = HyperConnection(dim, streams, fracs, layer_index=3)
    sd = {k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()}
    init = {k: v.detach().clone() for k, v in thc.state_dict().items()}
    init_j = jhc.init(jax.random.PRNGKey(0), jnp.asarray(s))["params"]
    for k, v in init.items():  # the same initial values (anchor = 3 % 4)
        np.testing.assert_array_equal(v.numpy(), np.asarray(init_j[k]), err_msg=k)
    thc.load_state_dict(sd)

    def jfn(p, s, o):
        branch, mixed = jhc.apply(p, s)
        return branch, mixed, jhc.apply(p, mixed, o)

    outs_j, vjp = jax.vjp(jfn, params, jnp.asarray(s), jnp.asarray(out))
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs_j]
    gp_j, gs_j, go_j = vjp(tuple(jnp.asarray(c) for c in cts))

    st, ot = torch.tensor(s, requires_grad=True), torch.tensor(out, requires_grad=True)
    branch, mixed = thc(st)
    written = thc(mixed, ot)
    outs_t = (branch, mixed, written)
    for a, b in zip(outs_t, outs_j):
        close(a.detach().numpy(), b, 1e-5, "phases")
    names = [k for k, _ in thc.named_parameters()]
    grads = torch.autograd.grad(sum((o * torch.tensor(c)).sum() for o, c in zip(outs_t, cts)),
                                [st, ot, *thc.parameters()])
    close(grads[0].numpy(), gs_j, 1e-4, "ds")
    close(grads[1].numpy(), go_j, 1e-4, "d branch out")
    for name, g in zip(names, grads[2:]):
        close(g.numpy(), gp_j["params"][name], 1e-4, name)
    np.testing.assert_allclose(reduce_stream(torch.tensor(s)).numpy(), s.mean(0), atol=1e-6)

    one = HyperConnection(dim, 1)
    assert not list(one.parameters())
    x = torch.tensor(out)
    s1 = expand_stream(x, 1)
    branch, s1m = one(s1)
    assert torch.equal(branch, x) and torch.equal(s1m, s1)
    assert torch.equal(reduce_stream(one(s1m, 2 * x)), 3 * x)
    assert expand_stream(x, 4).shape == (4, *x.shape)


CFG = dict(num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4), pad_multiple=16,
           prob_uncond=0.5)
MODEL = dict(dim=64, depth=2, dim_head=64, heads=2, attn_impl="flash", attn_laser=True,
             num_residual_streams=4, num_residual_fracs=4, fuse_projections=True)


@pytest.fixture(scope="module")
def model_pair():
    """The LASER + 4-stream + fused JAX model (initialized through its
    dense twin) and the port with the same weights."""
    dense = JaxTransfusion(transformer=dict(MODEL, attn_impl="dense"), **CFG)
    init = jax.jit(lambda key: dense.core.init(key, method="init_all"))
    params = jitter(init(jax.random.PRNGKey(0)))
    jm = JaxTransfusion(transformer=MODEL, **CFG)
    tm = Transfusion(transformer=MODEL, device="cpu", **CFG)
    tm.load_flax(np_tree(params))
    return jm, params, tm


def test_from_flax_maps_the_hyper_connections(model_pair):
    jm, params, tm = model_pair
    sd = from_flax(np_tree(params), tm)
    hc = params["params"]["transformer"]["block_1"]["hc_ff_1"]
    assert set(hc) == {"alpha_logit", "beta", "mix_logit", "alpha_dyn_kernel",
                       "alpha_dyn_scale"}
    for leaf, arr in hc.items():  # not kernels: no transpose
        np.testing.assert_array_equal(sd[f"transformer.blocks.1.hc_ff.{leaf}"].numpy(),
                                      np.asarray(arr))
    bad = jax.tree.map(np.asarray, params)
    bad["params"]["transformer"]["block_0"]["hc_attn_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        from_flax(bad, tm)


def samples(seed=0):
    rng = np.random.default_rng(seed)
    return [
        [rng.integers(0, 16, 5).astype(np.int32),
         (0, rng.standard_normal((4, 4, 8)).astype(np.float32)),
         rng.integers(0, 16, 3).astype(np.int32)],
        [rng.integers(0, 16, 9).astype(np.int32)],
        [(0, rng.standard_normal((2, 4, 8)).astype(np.float32))],
    ]


def core_params(tm, tree):
    sd = from_flax(np_tree(tree), tm)
    return {k: sd[k] for k, _ in tm.core.named_parameters()}


@pytest.fixture(scope="module")
def jax_loss(model_pair):
    """The JAX joint loss, its flow part and its gradients, with the draws
    handed to the port."""
    jm, params, tm = model_pair
    packed = jm.pack(samples(), shift_friendly=True)
    # times 0.13-0.72 (key 7 draws 0.988, where the x-prediction's
    # 1 / (1 - t) lifts the loss near 1000 and float32's ulp past 1e-4)
    rng = jax.random.PRNGKey(11)

    def jloss(p):
        return jm._loss_impl(p, jax.tree.map(jnp.asarray, packed), rng, None, None,
                             prob_uncond=0.5, velocity_delta=1e-3, train=True)

    (total, bd), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return float(total), float(bd.flow[0]), core_params(tm, grads), draws_from_key(rng, packed)


@pytest.mark.parametrize("remat", [False, True])
def test_joint_loss_and_grads_match_jax(model_pair, jax_loss, remat):
    """The joint loss and every gradient (the hyper-connections' among
    them) of the LASER + 4-stream + fused model, token-major route; with
    remat the block and its hyper-connections recompute in the backward."""
    jm, params, tm = model_pair
    total_j, flow_j, want, draws = jax_loss
    tm.core.transformer.remat = remat
    try:
        leaves = {k: p.requires_grad_(True) for k, p in core_params(tm, params).items()}
        packed_t = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
        total_t, bd_t = tm._loss_impl(leaves, packed_t, draws, 0.5, train=True)
        grads_t = torch.autograd.grad(total_t, list(leaves.values()), allow_unused=True)
    finally:
        tm.core.transformer.remat = False
    np.testing.assert_allclose(total_t.item(), total_j, atol=1e-4)
    np.testing.assert_allclose(bd_t.flow[0].item(), flow_j, atol=1e-4)
    assert any("hc_attn.alpha_dyn_kernel" in k for k in want)
    for (k, _), g in zip(leaves.items(), grads_t):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)


def spy_decode(monkeypatch):
    calls = []
    original = decode_attn.decode_attention

    def spy(*a, **k):
        calls.append(1)
        return original(*a, **k)

    from transfusion_tpu_torch.models import layers

    monkeypatch.setattr(layers, "decode_attention", spy)
    return calls


def test_cached_sample_matches_jax_off_the_decode_kernel(model_pair, monkeypatch, caplog):
    """sample(cache_kv=True), CFG 3.0, greedy text with injected noise: the
    same tokens and latents within 1e-3; no cached step reaches the decode
    kernel, and the exclusion is logged."""
    jm, params, tm = model_pair
    calls = spy_decode(monkeypatch)
    noise = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, 2, jm.som_ids[0]], np.int32)], max_length=24,
              modality_steps=4, init_modality_noise=noise, cfg_scale=3.0,
              text_temperature=0.0, cache_kv=True)
    out_j = jm.sample(params, rng=jax.random.PRNGKey(1), return_unprocessed_modalities=True,
                      **kw)
    with caplog.at_level(logging.INFO, logger="transfusion_tpu_torch.models.transformer"):
        out_t = tm.sample(**kw)
    assert not calls
    assert "decode kernel excluded for this cached step (LASER attention)" in caplog.text
    assert len(out_j) == len(out_t) and sum(isinstance(o, tuple) for o in out_t) == 1
    for a, b in zip(out_t, out_j):
        if isinstance(a, tuple):
            assert a[0] == b[0] and a[1].shape == b[1].shape == (4, 4, 8)
            np.testing.assert_allclose(a[1], np.asarray(b[1]), atol=1e-3)
        else:
            np.testing.assert_array_equal(a, np.asarray(b))


def test_generate_text_batch_matches_jax_off_the_decode_kernel(model_pair, monkeypatch):
    jm, params, tm = model_pair
    calls = spy_decode(monkeypatch)
    prompts = [np.asarray(p, np.int32) for p in ([16, 1, 2], [16, 3, 4, 5, 6, 7], [16, 2])]
    out_j = jm.generate_text_batch(params, prompts, max_new_tokens=6, temperature=0.0,
                                   rng=jax.random.PRNGKey(0))
    out_t = tm.generate_text_batch(prompts, max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert not calls


@pytest.mark.parametrize("cap,batch", [(256, 1), (8192, 8), (65536, 64)])
def test_plan_serving_laser_matches_jax(cap, batch):
    """A LASER model: the decode kernel excluded with JAX's reason, and
    JAX's KV choice and reasons."""
    got = plan_serving(cap, batch, laser=True)
    want = jax_plan_serving(cap, batch, laser=True)
    assert (got.use_decode_kernel, got.kv_quantize, got.reasons) == (
        want.use_decode_kernel, want.kv_quantize, want.reasons)
    dense = plan_serving(cap, batch, flash=False)
    want = jax_plan_serving(cap, batch, flash=False)
    assert (dense.use_decode_kernel, dense.reasons) == (want.use_decode_kernel, want.reasons)
    assert plan_serving(cap, batch).use_decode_kernel
    assert plan_serving(cap, batch, laser=True, kv_quantize=True).kv_quantize
