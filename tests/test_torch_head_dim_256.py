"""PyTorch port at head dim 256 against the JAX package, on the CPU.

The JAX route admits d 256 (`pallas_attn_kernel.py` `supported`, and
`nhd_eligible` where the envelope allows it); the port takes the same
routes. Here the port's plain versions (what its wrappers run on CPU
tensors) are held against the JAX Pallas kernels in interpret mode, as
tests/test_torch_train_attention.py runs them: the head-major forward and
backward with spans, q/kv offsets and an lse cotangent, the token-major
route with RoPE, one `Attention(dim_head=256)` on the uncached flash route
(both layouts), and a two-layer model's joint loss and every gradient.
Inputs are made with numpy from a seed; everything is float32. Tolerances
as the existing parity tests: 1e-5 for attention outputs, 1e-4 for
gradients, lse and whole layers or models (their sums run over up to 512
products in another order); the model's gradients, which reach ~1e2, also
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_attention import arrays, assert_close, jax_grads, torch_grads
from test_torch_training import core_params, draws_from_key, jitter, np_tree, samples
from transfusion_tpu.models.layers import Attention as JaxAttention
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.ops import pallas_attn_kernel as jflash
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.layers import Attention
from transfusion_tpu_torch.ops import flash_attn, flash_attn_nhd
from transfusion_tpu_torch.ops.rope import rope_angles

torch.set_num_threads(1)

D = 256
SPANS = np.asarray([[[0, 5, 20], [0, 40, 17]], [[0, 10, 0], [0, 30, 25]]], np.int32)


def test_routes_take_head_dim_256():
    assert flash_attn.supported(300, D) and jflash.supported(300, D)
    assert 256 in flash_attn.HEAD_DIMS
    for h, n in ((2, 64), (2, 256), (4, 128), (2, 60), (1, 512)):
        assert flash_attn_nhd.nhd_eligible(h, n, D) == jflash.nhd_eligible(h, n, D), (h, n)


@pytest.mark.parametrize("q_off,kv_off", [(0, 0), (32, 16)])
def test_head_major_forward_and_grads_match_jax(q_off, kv_off):
    """b2 h2 n96 (no multiple of the kernels' 64-row tiles; the JAX route
    with offsets and lse takes multiples of 8) with two spans per row; out
    and lse, then dq/dk/dv for an output and an lse cotangent."""
    b, h, n = 2, 2, 96
    q, k, v, go = arrays(*[(b, h, n, D)] * 4, seed=11)
    (gl,) = arrays((b, h, n), seed=12)
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off, return_lse=True)
    outs_t, g_t = torch_grads(
        lambda q, k, v: flash_attn.flash_attention(q, k, v, spans=torch.tensor(SPANS), **kw),
        (q, k, v), (go, gl))
    outs_j, g_j = jax_grads(
        lambda q, k, v: jflash.flash_attention(q, k, v, spans=jnp.asarray(SPANS), **kw),
        (q, k, v), (go, gl))
    assert_close(outs_t[:1], outs_j[:1], 1e-5, "out")
    assert_close(outs_t[1:], outs_j[1:], 1e-4, "lse")
    assert_close(g_t, g_j, 1e-4, "dq/dk/dv")


def test_token_major_rope_forward_and_grads_match_jax():
    """b2 h2 n64 d256 token-major with RoPE (a distinct row per batch
    entry) and two spans."""
    b, h, n = 2, 2, 64
    assert flash_attn_nhd.nhd_eligible(h, n, D)
    q, k, v, go = arrays(*[(b, n, h * D)] * 4, seed=13)
    ang = rope_angles(torch.tensor(np.stack([np.arange(n), np.arange(n) // 2])), D).numpy()
    cos, sin = np.cos(ang), np.sin(ang)
    out_t, g_t = torch_grads(
        lambda q, k, v: flash_attn_nhd.flash_attention_nhd(
            q, k, v, h, torch.tensor(cos), torch.tensor(sin), spans=torch.tensor(SPANS),
            causal=True), (q, k, v), (go,))
    out_j, g_j = jax_grads(
        lambda q, k, v: jflash.flash_attention_nhd(
            q, k, v, h, cos=jnp.asarray(cos), sin=jnp.asarray(sin), spans=jnp.asarray(SPANS),
            causal=True), (q, k, v), (go,))
    assert_close(out_t, out_j, 1e-5, "forward")
    assert_close(g_t, g_j, 1e-4, "dq/dk/dv")


@pytest.mark.parametrize("n", [64, 60], ids=["token-major", "head-major"])
def test_attention_layer_matches_jax(n):
    """One `Attention(dim=64, dim_head=256, heads=2)` on the uncached flash
    route with RoPE and spans, with the JAX layer's weights: the output and
    the gradients of a seeded cotangent with respect to x and every
    weight."""
    b, dim = 2, 64
    assert flash_attn_nhd.nhd_eligible(2, n, D) == (n == 64)
    x, go = arrays((b, n, dim), (b, n, dim), seed=14)
    ang = rope_angles(torch.arange(n), D)[None].numpy()
    jl = JaxAttention(dim=dim, dim_head=D, heads=2, attn_impl="flash")
    spec_j = {"spans": jnp.asarray(SPANS), "causal": True}
    params = jitter(jl.init(jax.random.PRNGKey(0), jnp.asarray(x), rope=jnp.asarray(ang),
                            flash_spec=spec_j))
    p = jax.tree.map(np.asarray, params)["params"]

    tl = Attention(dim, dim_head=D, heads=2, attn_impl="flash")
    tl.load_state_dict({f"{name}.weight": torch.tensor(p[name]["kernel"].T)
                        for name in ("to_qk", "to_v", "to_gates", "to_out")})
    spec_t = {"spans": torch.tensor(SPANS), "causal": True}
    names = [k for k, _ in tl.named_parameters()]

    def jfn(x, params):
        return jl.apply(params, x, rope=jnp.asarray(ang), flash_spec=spec_j)[0]

    out_j, vjp = jax.vjp(jfn, jnp.asarray(x), params)
    gx_j, gp_j = vjp(jnp.asarray(go))
    gp_j = jax.tree.map(np.asarray, gp_j)["params"]

    xt = torch.tensor(x, requires_grad=True)
    out_t = tl(xt, rope=torch.tensor(ang), flash_spec=spec_t)[0]
    grads = torch.autograd.grad((out_t * torch.tensor(go)).sum(), [xt, *tl.parameters()])
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-4)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j), atol=1e-4)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), gp_j[name.split(".")[0]]["kernel"].T, atol=1e-4,
                                   err_msg=name)


def test_two_layer_model_loss_and_grads_match_jax():
    """A depth-2 model with 2 heads of 256 (the packed n 48 takes the
    token-major route): the joint loss, its text and flow parts and every
    parameter's gradient, from the same weights and draws. Gradients reach
    ~1e2 here, where float32's own spacing is ~1e-5: they are held within
    1e-4 plus 1e-5 of their size."""
    cfg = dict(num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4),
               pad_multiple=16, prob_uncond=0.5)
    tcfg = dict(dim=64, depth=2, dim_head=D, heads=2, attn_impl="flash")
    jm = JaxTransfusion(transformer=tcfg, **cfg)
    dense = JaxTransfusion(transformer=dict(tcfg, attn_impl="dense"), **cfg)
    init = jax.jit(lambda key: dense.core.init(key, method="init_all"))
    params = jitter(init(jax.random.PRNGKey(0)))
    tm = Transfusion(transformer=tcfg, device="cpu", **cfg)
    tm.load_flax(np_tree(params))

    packed = jm.pack(samples(), shift_friendly=True)
    assert flash_attn_nhd.nhd_eligible(2, packed.text.shape[1] - 1, D)
    rng = jax.random.PRNGKey(7)
    draws = draws_from_key(rng, packed)

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
    np.testing.assert_allclose(bd_t.flow[0].item(), float(bd_j.flow[0]), atol=1e-4)
    want = core_params(tm, grads_j)
    for (k, _), g in zip(leaves.items(), grads_t):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, rtol=1e-5,
                                   err_msg=k)
