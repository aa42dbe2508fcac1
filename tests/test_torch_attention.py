"""PyTorch port: the two attention kernels' plain versions against the JAX
Pallas kernels (run in interpret mode on the CPU, as tests/test_pallas_attn.py
runs them) and the CPU routing of the wrappers. The CUDA kernels against
their plain versions are in test_torch_cuda.py.

Inputs are made with numpy from a seed; comparisons are float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.models.layers import _quantize_rows as j_quantize_rows
from transfusion_tpu.ops import pallas_attn_kernel as jflash
from transfusion_tpu.ops.pallas_decode_kernel import decode_attention as j_decode
from transfusion_tpu_torch.models.layers import _quantize_rows
from transfusion_tpu_torch.ops import decode_attn, flash_attn

torch.set_num_threads(1)


def qkv(b, h, n, d, seed=0, nkv=None):
    rng = np.random.default_rng(seed)
    nkv = n if nkv is None else nkv
    return (rng.standard_normal((b, h, n, d)).astype(np.float32),
            rng.standard_normal((b, h, nkv, d)).astype(np.float32),
            rng.standard_normal((b, h, nkv, d)).astype(np.float32))


SPANS = np.asarray([[[0, 3, 20], [0, 40, 17]], [[0, 10, 0], [0, 30, 25]]], np.int32)


def test_jax_routes_under_test():
    """The shapes below select the batched-heads and the blocked kernels."""
    assert jflash._use_batched(2, 128, 128, 32, bwd=False)
    assert not jflash._use_batched(1, 640, 640, 32, bwd=False)


@pytest.mark.parametrize(
    "b,h,n,d",
    [(2, 2, 128, 32),   # _kernel_batched_heads
     (2, 1, 640, 32),   # _kernel (blocked online softmax)
     (2, 2, 100, 32)],  # ragged n: JAX pads to 128, the port masks the edge
)
def test_flash_plain_matches_jax(b, h, n, d):
    q, k, v = qkv(b, h, n, d)
    spans = SPANS[:b]
    out_t = flash_attn.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        spans=torch.tensor(spans, dtype=torch.int64), causal=True,
    )
    out_j = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   spans=jnp.asarray(spans), causal=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


@pytest.mark.parametrize("h,n", [(2, 64), (1, 640)])
def test_flash_plain_offsets_and_lse_match_jax(h, n):
    q, k, v = qkv(2, h, n, 32, seed=1)
    kw = dict(causal=True, q_offset=n // 2, kv_offset=n // 4, return_lse=True)
    out_t, lse_t = flash_attn.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        spans=torch.tensor(SPANS, dtype=torch.int64), **kw)
    out_j, lse_j = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          spans=jnp.asarray(SPANS), **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5)


def test_flash_plain_fully_masked_rows():
    """q rows before every kv column see nothing: out 0, lse ~ -1e30, as the
    JAX batched kernel returns them."""
    q, k, v = qkv(1, 2, 64, 32, seed=2)
    kw = dict(causal=True, q_offset=0, kv_offset=32, return_lse=True)
    out_t, lse_t = flash_attn.flash_attention(torch.tensor(q), torch.tensor(k),
                                              torch.tensor(v), **kw)
    out_j, lse_j = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    assert (out_t[:, :, :32] == 0).all()
    assert (lse_t[:, :, :32] < -1e29).all() and (np.asarray(lse_j)[:, :, :32] < -1e29).all()
    np.testing.assert_allclose(lse_t[:, :, 32:].numpy(), np.asarray(lse_j)[:, :, 32:], atol=1e-5)


def test_flash_needs_causal_or_spans():
    q, k, v = (torch.tensor(t) for t in qkv(1, 1, 8, 32))
    with pytest.raises(ValueError, match="causal"):
        flash_attn.flash_attention(q, k, v)


def _decode_inputs(cap=256, nq=5, seed=3):
    b, h, d = 3, 2, 32
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    v = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    lens = np.asarray([100, 0, 163], np.int32)  # row 1: no valid slot at all
    valid = np.arange(cap)[None, :] < lens[:, None]
    valid[2, 20:60] = False  # a hole: valid slots need not be a prefix
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias, lens


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq", [1, 5])
def test_decode_plain_matches_jax(int8, nq):
    q, k, v, bias, lens = _decode_inputs(nq=nq)
    b = q.shape[0]
    j_bias = jnp.broadcast_to(jnp.asarray(bias)[:, None, :], (b, 8, bias.shape[1]))
    if int8:
        k8, ks = j_quantize_rows(jnp.asarray(k))
        v8, vs = j_quantize_rows(jnp.asarray(v))
        out_j = j_decode(jnp.asarray(q), k8.swapaxes(-1, -2), v8.swapaxes(-1, -2), j_bias,
                         k_scale=ks.swapaxes(-1, -2), v_scale=vs.swapaxes(-1, -2),
                         lens=jnp.asarray(lens))
        tk8, tks = _quantize_rows(torch.tensor(k))
        tv8, tvs = _quantize_rows(torch.tensor(v))
        out_t = decode_attn.decode_attention(
            torch.tensor(q), tk8, tv8, torch.tensor(bias), tks[..., 0], tvs[..., 0],
            lens=torch.tensor(lens))
    else:
        out_j = j_decode(jnp.asarray(q), jnp.asarray(k).swapaxes(-1, -2),
                         jnp.asarray(v).swapaxes(-1, -2), j_bias, lens=jnp.asarray(lens))
        out_t = decode_attn.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                             torch.tensor(bias), lens=torch.tensor(lens))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    assert (out_t[1] == 0).all()  # the row with no valid slot outputs 0


def test_cpu_wrappers_take_the_plain_version():
    q, k, v = (torch.tensor(t) for t in qkv(1, 2, 16, 32))
    before = (flash_attn.flash_attention.launches, decode_attn.decode_attention.launches)
    out = flash_attn.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, flash_attn.flash_attention_plain(q, k, v)[0])
    bias = torch.zeros(1, 16)
    out = decode_attn.decode_attention(q, k, v, bias)
    assert torch.equal(out, decode_attn.decode_attention_plain(q, k, v, bias))
    after = (flash_attn.flash_attention.launches, decode_attn.decode_attention.launches)
    assert before == after


def test_decode_supported_shapes():
    assert decode_attn.decode_supported(64, 196)
    assert decode_attn.decode_supported(64, 1024)
    assert not decode_attn.decode_supported(64, 1025)
    assert not decode_attn.decode_supported(48, 1)
