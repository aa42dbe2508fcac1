"""PyTorch port: the attention routes of the training step against the JAX
package, forward and gradients. The JAX side runs its Pallas kernels in
interpret mode on the CPU (as tests/test_pallas_attn.py does); the port
runs the plain versions of its kernels (the CUDA kernels against those
plain versions are in test_torch_cuda.py). Inputs are made with numpy from
a seed; everything is float32. Tolerances: 1e-5 for forwards, 1e-4 for
gradients (their sums run over n = 64..640 products in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.ops import pallas_attn_kernel as jflash
from transfusion_tpu_torch.ops import flash_attn, flash_attn_nhd
from transfusion_tpu_torch.ops.rope import rope_angles

torch.set_num_threads(1)

SPANS2 = np.asarray([[[0, 5, 20], [0, 40, 17]], [[0, 10, 0], [0, 30, 25]]], np.int32)


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def torch_grads(fn, inputs, cotangents):
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cotangents))
    return [o.detach().numpy() for o in outs], [g.numpy() for g in torch.autograd.grad(total, ts)]


def jax_grads(fn, inputs, cotangents):
    outs, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in inputs))
    tup = outs if isinstance(outs, tuple) else (outs,)
    cts = tuple(jnp.asarray(c) for c in cotangents)
    grads = vjp(cts if isinstance(outs, tuple) else cts[0])
    return [np.asarray(o) for o in tup], [np.asarray(g) for g in grads]


def assert_close(got, want, atol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=f"{what} [{i}]")


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("spans", [None, SPANS2])
def test_nhd_forward_and_grads_match_jax(rope, spans):
    """Token-major route at b2 h2 n64 d64: causal, and with 2 spans."""
    b, h, n, d = 2, 2, 64, 64
    assert jflash.nhd_eligible(h, n, d) and flash_attn_nhd.nhd_eligible(h, n, d)
    q, k, v, go = arrays(*[(b, n, h * d)] * 4, seed=1)
    cos = sin = None
    if rope:
        pos = np.stack([np.arange(n), np.arange(n) // 2])  # a distinct row per batch entry
        ang = rope_angles(torch.tensor(pos), d).numpy()
        cos, sin = np.cos(ang), np.sin(ang)
    sp_t = None if spans is None else torch.tensor(spans)
    sp_j = None if spans is None else jnp.asarray(spans)
    cs_t = None if cos is None else torch.tensor(cos)
    sn_t = None if sin is None else torch.tensor(sin)
    cs_j = None if cos is None else jnp.asarray(cos)
    sn_j = None if sin is None else jnp.asarray(sin)

    out_t, g_t = torch_grads(
        lambda q, k, v: flash_attn_nhd.flash_attention_nhd(
            q, k, v, h, cs_t, sn_t, spans=sp_t, causal=True), (q, k, v), (go,))
    out_j, g_j = jax_grads(
        lambda q, k, v: jflash.flash_attention_nhd(
            q, k, v, h, cos=cs_j, sin=sn_j, spans=sp_j, causal=True), (q, k, v), (go,))
    assert_close(out_t, out_j, 1e-5, "forward")
    assert_close(g_t, g_j, 1e-4, "dq/dk/dv")


@pytest.mark.parametrize("h,n,d", [(2, 128, 32),   # row 7: _bwd_kernel_batched_heads
                                   (1, 640, 64)])  # row 8: _bwd_dkv_kernel + _bwd_dq_kernel
def test_head_major_grads_match_jax(h, n, d):
    b = 2
    assert jflash._use_batched(h, n, n, d, bwd=True) == (n == 128)
    q, k, v, go = arrays(*[(b, h, n, d)] * 4, seed=2)
    out_t, g_t = torch_grads(
        lambda q, k, v: flash_attn.flash_attention(q, k, v, spans=torch.tensor(SPANS2),
                                                   causal=True), (q, k, v), (go,))
    out_j, g_j = jax_grads(
        lambda q, k, v: jflash.flash_attention(q, k, v, spans=jnp.asarray(SPANS2), causal=True),
        (q, k, v), (go,))
    assert_close(out_t, out_j, 1e-5, "forward")
    assert_close(g_t, g_j, 1e-4, "dq/dk/dv")


@pytest.mark.parametrize("h,n", [(2, 128), (1, 640)])
def test_offsets_and_lse_cotangent_match_jax(h, n):
    """q/kv offsets (ring attention's chunks) and a nonzero lse cotangent,
    which folds into delta."""
    b, d = 2, 32
    q, k, v, go = arrays(*[(b, h, n, d)] * 4, seed=3)
    (gl,) = arrays((b, h, n), seed=4)
    kw = dict(causal=True, q_offset=n // 2, kv_offset=n // 4, return_lse=True)
    outs_t, g_t = torch_grads(
        lambda q, k, v: flash_attn.flash_attention(q, k, v, spans=torch.tensor(SPANS2), **kw),
        (q, k, v), (go, gl))
    outs_j, g_j = jax_grads(
        lambda q, k, v: jflash.flash_attention(q, k, v, spans=jnp.asarray(SPANS2), **kw),
        (q, k, v), (go, gl))
    assert_close(outs_t, outs_j, 1e-4, "out/lse")
    assert_close(g_t, g_j, 1e-4, "dq/dk/dv")


def test_fully_masked_rows_get_zero_grads():
    """q rows before every kv column see nothing: their dq is exactly 0 and
    they add nothing to dk/dv (the JAX batched backward's where(allowed))."""
    b, h, n, d = 1, 2, 64, 32
    q, k, v, go = arrays(*[(b, h, n, d)] * 4, seed=5)
    kw = dict(causal=True, q_offset=0, kv_offset=32)
    _, g_t = torch_grads(lambda q, k, v: flash_attn.flash_attention(q, k, v, **kw),
                         (q, k, v), (go,))
    _, g_j = jax_grads(lambda q, k, v: jflash.flash_attention(q, k, v, **kw), (q, k, v), (go,))
    assert (g_t[0][:, :, :32] == 0).all()
    assert_close(g_t, g_j, 1e-4, "dq/dk/dv")
    # the same grads with the dead rows' cotangent removed: they add nothing
    go2 = go.copy()
    go2[:, :, :32] = 0
    _, g_t2 = torch_grads(lambda q, k, v: flash_attn.flash_attention(q, k, v, **kw),
                          (q, k, v), (go2,))
    assert_close(g_t[1:], g_t2[1:], 1e-6, "dk/dv")


@pytest.mark.parametrize("nhd", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(nhd):
    """The written-out backward against torch.autograd through the plain
    forward, with spans, rope (token-major) and offsets + lse (head-major)."""
    b, h, n, d = 2, 2, 64, 64
    if nhd:
        q, k, v, go = arrays(*[(b, n, h * d)] * 4, seed=6)
        ang = rope_angles(torch.arange(n), d)[None]
        cos, sin = torch.cos(ang), torch.sin(ang)
        sp = torch.tensor(SPANS2)

        def plain(q, k, v):
            return flash_attn_nhd.flash_attention_nhd_plain(q, k, v, h, cos, sin, sp)[0]

        def fused(q, k, v):
            return flash_attn_nhd.flash_attention_nhd(q, k, v, h, cos, sin, spans=sp)
        cts = (go,)
    else:
        q, k, v, go = arrays(*[(b, h, n, d)] * 4, seed=7)
        (gl,) = arrays((b, h, n), seed=8)
        sp = torch.tensor(SPANS2)

        def plain(q, k, v):
            return flash_attn.flash_attention_plain(q, k, v, sp, 50.0, 16, 8)

        def fused(q, k, v):
            return flash_attn.flash_attention(q, k, v, spans=sp, q_offset=16, kv_offset=8,
                                              return_lse=True)
        cts = (go, gl)
    _, g_auto = torch_grads(plain, (q, k, v), cts)
    _, g_kern = torch_grads(fused, (q, k, v), cts)
    assert_close(g_kern, g_auto, 1e-5, "written-out vs autograd")


def test_routing_predicates_match_jax():
    for h, n, d in [(8, 256, 64), (8, 1024, 64), (2, 64, 64), (2, 48, 32), (4, 264, 128),
                    (1, 128, 256), (2, 60, 64)]:
        assert flash_attn_nhd.nhd_eligible(h, n, d) == jflash.nhd_eligible(h, n, d), (h, n, d)
    for n, d in [(256, 64), (1024, 48), (8192 * 32, 64), (100, 256)]:
        assert flash_attn.supported(n, d) == jflash.supported(n, d), (n, d)


def test_cpu_wrappers_take_the_plain_version():
    q, k, v, go = (torch.tensor(x, requires_grad=True)
                   for x in arrays(*[(1, 64, 128)] * 4, seed=9))
    before = (flash_attn_nhd.flash_attention_nhd.launches,
              flash_attn_nhd.flash_attention_nhd_backward.launches,
              flash_attn.flash_attention_backward.launches)
    out = flash_attn_nhd.flash_attention_nhd(q, k, v, 2, causal=True)
    out.backward(go.detach())
    after = (flash_attn_nhd.flash_attention_nhd.launches,
             flash_attn_nhd.flash_attention_nhd_backward.launches,
             flash_attn.flash_attention_backward.launches)
    assert before == after
    with pytest.raises(ValueError, match="not eligible"):
        flash_attn_nhd.flash_attention_nhd(q[:, :60], k[:, :60], v[:, :60], 2, causal=True)
