"""PyTorch port: cached decode at head dim 256 and the split-K design of
`csrc/decode_attn.cu`, on the CPU.

- `decode_attention_plain` (what the wrapper runs on CPU tensors) against
  the JAX `decode_attention` (Pallas interpret mode) at d 256 for float32,
  bf16 and int8 caches: within 1e-5, as tests/test_torch_attention.py holds
  the smaller head dims (the two sum 256 products in another order).
- `split_plan`, the host-side plan of the kernel's chunks, and
  `merge_partials`, the merge kernel's arithmetic, against the plain
  version: per-chunk partials computed here in plain PyTorch, merged, equal
  the unsplit softmax within 1e-5 (float32, other summation order), with
  chunks wholly past lens, rows with no valid slot (exactly 0) and no NaN.
- A depth-2 float32 model with 2 heads of 256: cached greedy
  `generate_text_only` gives the JAX package's tokens, and its cached steps
  take the decode route.
- The flash wrappers' validation takes any span count and any b * h.

Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import jitter, np_tree
from transfusion_tpu.models.layers import _quantize_rows as j_quantize_rows
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.ops.pallas_decode_kernel import decode_attention as j_decode
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models import layers
from transfusion_tpu_torch.models.layers import _quantize_rows
from transfusion_tpu_torch.ops import decode_attn, flash_attn
from transfusion_tpu_torch.ops.norms import NEG_INF

torch.set_num_threads(1)

D = 256
H100_SMS = 132


def decode_inputs(cap=256, nq=5, d=D, seed=3, lens=(100, 0, 163)):
    b, h = len(lens), 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    v = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    lens = np.asarray(lens, np.int32)  # a row with no valid slot at all
    valid = np.arange(cap)[None, :] < lens[:, None]
    valid[-1, 20:60] = False  # a hole: valid slots need not be a prefix
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias, lens


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nq", [1, 5])
def test_decode_plain_matches_jax_at_head_dim_256(kv, nq):
    q, k, v, bias, lens = decode_inputs(nq=nq)
    b = q.shape[0]
    j_bias = jnp.broadcast_to(jnp.asarray(bias)[:, None, :], (b, 8, bias.shape[1]))
    jq, tq = jnp.asarray(q), torch.tensor(q)
    if kv == "int8":
        k8, ks = j_quantize_rows(jnp.asarray(k))
        v8, vs = j_quantize_rows(jnp.asarray(v))
        out_j = j_decode(jq, k8.swapaxes(-1, -2), v8.swapaxes(-1, -2), j_bias,
                         k_scale=ks.swapaxes(-1, -2), v_scale=vs.swapaxes(-1, -2),
                         lens=jnp.asarray(lens))
        tk8, tks = _quantize_rows(torch.tensor(k))
        tv8, tvs = _quantize_rows(torch.tensor(v))
        out_t = decode_attn.decode_attention(tq, tk8, tv8, torch.tensor(bias), tks[..., 0],
                                             tvs[..., 0], lens=torch.tensor(lens))
    else:
        jdt, tdt = (jnp.float32, torch.float32) if kv == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
        out_j = j_decode(jq, jnp.asarray(k, jdt).swapaxes(-1, -2),
                         jnp.asarray(v, jdt).swapaxes(-1, -2), j_bias, lens=jnp.asarray(lens))
        out_t = decode_attn.decode_attention(tq, torch.tensor(k).to(tdt), torch.tensor(v).to(tdt),
                                             torch.tensor(bias), lens=torch.tensor(lens))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j, np.float32), atol=1e-5)
    assert (out_t[1] == 0).all()  # the row with no valid slot outputs 0


# (b, h, nq, cap): the bench model's text decode (cap 1152) and ODE (CFG
# rows, nq 196), the 573M long-prompt window (h 16, cap 8320), the
# long-context card case, tiny caches and a ragged capacity, b * h past a
# full card, one head
PLAN_SHAPES = [
    (8, 8, 1, 1152), (2, 8, 196, 384), (8, 16, 1, 8320), (8, 8, 1, 8192), (4, 8, 196, 8192),
    (1, 1, 1, 64), (1, 1, 1, 100), (3, 2, 5, 1000), (2, 2, 16, 128), (64, 16, 1, 256),
    (1, 1, 1, 131072), (1, 8, 1024, 4096), (1, 2, 17, 640),
]


@pytest.mark.parametrize("b,h,nq,cap", PLAN_SHAPES)
def test_split_plan_covers_the_cache(b, h, nq, cap):
    splits, chunk = decode_attn.split_plan(b, h, nq, cap, H100_SMS)
    assert chunk > 0 and chunk % 64 == 0
    # the chunks [s * chunk, min((s + 1) * chunk, cap)) cover [0, cap) exactly
    assert (splits - 1) * chunk < cap <= splits * chunk
    q_tiles = nq if nq <= decode_attn.WARP_ROWS else -(-nq // decode_attn.TILE_ROWS)
    blocks = b * h * q_tiles * splits
    assert blocks <= 2**31 - 1  # a one-dimensional grid
    # at least two blocks an SM wherever the cache has enough 64-slot tiles
    assert blocks >= 2 * H100_SMS or splits == -(-cap // 64)


def chunk_partials(q, k, v, bias, lens, splits, chunk, softcap=50.0):
    """What each of the kernel's blocks writes, in plain PyTorch: for chunk
    s, the slots [s * chunk, min((s + 1) * chunk, lens[b])): the max m, the
    sum l of exp(s - m) and the unnormalised acc = sum exp(s - m) v. A chunk
    wholly past lens[b] writes m = -1e30, l = 0 and no acc (NaN here)."""
    d, cap = q.shape[-1], k.shape[2]
    s_all = torch.matmul(q * d**-0.5, k.transpose(-1, -2))
    s_all = torch.tanh(s_all / softcap) * softcap + bias[:, None, None, :]
    slot = torch.arange(cap)
    ms, ls, accs = [], [], []
    for sp in range(splits):
        inside = (slot >= sp * chunk) & (slot < (sp + 1) * chunk)
        inside = inside[None, :] & (slot[None, :] < lens[:, None])  # [b, cap]
        s = s_all.masked_fill(~inside[:, None, None, :], NEG_INF)
        m = s.amax(-1)
        live = (m > 0.5 * NEG_INF)[..., None]
        p = torch.where(live & inside[:, None, None, :], torch.exp(s - m[..., None]), 0.0)
        empty = ~inside.any(-1)[:, None, None]  # [b, 1, 1]
        ms.append(torch.where(empty, NEG_INF, m))
        ls.append(torch.where(empty, 0.0, p.sum(-1)))
        accs.append(torch.where(empty[..., None], float("nan"), torch.matmul(p, v)))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


@pytest.mark.parametrize("cap,lens,sms", [
    (256, (100, 0, 163), H100_SMS),  # row 1: no valid slot; chunks past lens
    (1000, (1000, 37, 0), H100_SMS),  # a ragged last chunk, a row of one chunk
    (640, (640, 400, 128), 1),  # one SM: a single chunk
])
@pytest.mark.parametrize("nq", [1, 20])
def test_merge_of_chunk_partials_matches_plain(cap, lens, sms, nq):
    q, k, v, bias, lens_np = decode_inputs(cap=cap, nq=nq, d=64, seed=5, lens=lens)
    q, k, v, bias, lens_t = map(torch.tensor, (q, k, v, bias, lens_np))
    splits, chunk = decode_attn.split_plan(*q.shape[:3], cap, sms)
    if sms > 1:
        assert splits > 1
    m, l, acc = chunk_partials(q, k, v, bias, lens_t, splits, chunk)
    if splits > 1:
        assert torch.isnan(acc).any()  # chunks past a row's length write no acc
    out = decode_attn.merge_partials(m, l, acc)
    ref = decode_attn.decode_attention_plain(q, k, v, bias, lens=lens_t)
    assert not torch.isnan(out).any()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    for i, n in enumerate(lens_np):
        if n == 0:
            assert (out[i] == 0).all()  # no valid slot: exactly 0


def test_cached_decode_at_head_dim_256_takes_the_kernel_route_and_matches_jax(monkeypatch):
    """A depth-2 model with 2 heads of 256: the greedy tokens of cached
    `generate_text_only` equal the JAX package's, and every cached step
    after the prefill went through `layers.decode_attention` (the dense
    cached path does not call it)."""
    assert decode_attn.decode_supported(D, 1) and decode_attn.decode_supported(D, 196)
    cfg = dict(num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4), pad_multiple=16)
    tcfg = dict(dim=64, depth=2, dim_head=D, heads=2, attn_impl="flash")
    jm = JaxTransfusion(transformer=tcfg, **cfg)
    dense = JaxTransfusion(transformer=dict(tcfg, attn_impl="dense"), **cfg)
    params = jitter(dense.init_params(jax.random.PRNGKey(0)))
    tm = Transfusion(transformer=tcfg, device="cpu", **cfg)
    tm.load_flax(np_tree(params))

    calls = []
    real = layers.decode_attention

    def spy(q, *args, **kw):
        calls.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(layers, "decode_attention", spy)
    prompt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    new = 6
    out_t = tm.generate_text_only(prompt, seq_len=4 + new, temperature=0.0)
    out_j = jm.generate_text_only(params, prompt, seq_len=4 + new, temperature=0.0,
                                  kv_quantize=False, rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # one call per layer per cached step, each one query row of head dim 256
    assert len(calls) == tcfg["depth"] * new
    assert all(c == (2, 2, 1, D) for c in calls)


def test_flash_wrappers_take_any_span_count_and_b_times_h():
    """The kernels read the spans from device memory and run one-dimensional
    grids: 200 spans and b * h = 70000 reach them."""
    q = torch.zeros(1, 1, 8, 64)
    flash_attn._check("flash_attention", q, q, q, 7000, 10, 8, 8, 64, 0, 0)
    spans = torch.zeros(2, 200, 3, dtype=torch.int64)
    out = flash_attn._spans_arg("flash_attention", spans, 2, torch.device("cpu"))
    assert out.shape == (2, 200, 3) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="int32"):  # the position check stays
        flash_attn._check("flash_attention", q, q, q, 1, 1, 8, 8, 64, 2**31 - 4, 0)
