"""PyTorch port on a CUDA card: each CUDA kernel (forward and backward)
against its plain PyTorch version, and the serving path and a training
step on the card against the same weights on the CPU. Every test here is marked `cuda` and skips without a GPU (the CUDA
kernels have no CPU mode). This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.layers import _quantize_rows
from transfusion_tpu_torch.ops import decode_attn, flash_attn, flash_attn_nhd
from transfusion_tpu_torch.ops.rope import rope_angles
from transfusion_tpu_torch.training import Trainer

pytestmark = pytest.mark.cuda

SPANS = np.asarray([[[0, 3, 20], [0, 40, 17]], [[0, 10, 0], [0, 30, 25]]], np.int32)
CFG = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,), pad_multiple=16,
           transformer=dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="flash"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(*shape, seed=0, device="cuda", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d", [(130, 32), (1000, 64), (200, 128), (300, 256), (64, 64)])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, n, d):
    q, k, v = (randn(2, 2, n, d, seed=s, dtype=dtype) for s in range(3))
    spans = torch.tensor(SPANS, device=cuda_device)
    for q_off, kv_off in ((0, 0), (64, 16), (0, 48)):
        out, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True,
                                              q_offset=q_off, kv_offset=kv_off,
                                              return_lse=True)
        ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, spans, 50.0, q_off, kv_off)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol
        live = ref_lse > -1e29
        assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-4
        assert (lse[~live] < -1e29).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq", [1, 196])
def test_decode_kernel_matches_plain(cuda_device, dtype, tol, int8, nq):
    b, h, cap, d = 3, 2, 1000, 64
    q = randn(b, h, nq, d, seed=1, dtype=dtype)
    k, v = (randn(b, h, cap, d, seed=s, dtype=dtype) for s in (2, 3))
    lens = torch.tensor([100, 0, 1000], dtype=torch.int32, device=cuda_device)
    valid = torch.arange(cap, device=cuda_device)[None, :] < lens[:, None]
    valid[2, 20:60] = False
    bias = torch.where(valid, 0.0, -1e30).float().contiguous()
    ks = vs = None
    if int8:
        k, ks = _quantize_rows(k)
        v, vs = _quantize_rows(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    args = (q, k, v, bias, ks, vs, 50.0, lens)
    out = decode_attn.decode_attention(*args)
    ref = decode_attn.decode_attention_plain(*args).to(dtype)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out[1] == 0).all()


def decode_args(b, h, nq, cap, d, dtype, lens, int8, seed=1, hole=True):
    q = randn(b, h, nq, d, seed=seed, dtype=dtype)
    k, v = (randn(b, h, cap, d, seed=s, dtype=dtype) for s in (seed + 1, seed + 2))
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    valid = torch.arange(cap, device="cuda")[None, :] < lens[:, None]
    if hole:
        valid[-1, 20:60] = False
    bias = torch.where(valid, 0.0, -1e30).float().contiguous()
    ks = vs = None
    if int8:
        k, ks = _quantize_rows(k)
        v, vs = _quantize_rows(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    return q, k, v, bias, ks, vs, 50.0, lens


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq", [1, 5, 196])
@pytest.mark.parametrize("d", [32, 128, 256])
def test_decode_kernel_head_dims_match_plain(cuda_device, dtype, tol, int8, nq, d):
    """Every path of the split kernel at head dims 32-256: one query row a
    block (nq 1, 5), the tensor cores (nq 196, bf16 q with a bf16 or int8
    cache) and the FMA tiles (nq 196, float32). Row 1 has no valid slot
    (exactly 0), row 0's lens leaves whole chunks past it, row 2 has a hole
    in its bias."""
    args = decode_args(3, 2, nq, 1000, d, dtype, [100, 0, 1000], int8)
    before = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(*args)
    ref = decode_attn.decode_attention_plain(*args).to(dtype)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == before + 1
    assert out.dtype == dtype and not out.isnan().any()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out[1] == 0).all()


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_decode_kernel_long_cache_matches_plain(cuda_device, kv):
    """Long-context text decode, b8 h8 nq1 cap8192 d64, lens 8192 - 37 i:
    where the unsplit kernel streamed each row's history alone."""
    dtype = torch.float32 if kv == "float32" else torch.bfloat16
    lens = [8192 - 37 * i for i in range(8)]
    args = decode_args(8, 8, 1, 8192, 64, dtype, lens, kv == "int8", hole=False)
    out = decode_attn.decode_attention(*args)
    ref = decode_attn.decode_attention_plain(*args).to(dtype)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= (1e-4 if kv == "float32" else 2e-2)


def token_major(q):
    """q [b, h, nq, d] as the model hands it in: a view of [b, nq, h, d]."""
    return q.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nq", [5, 196])
def test_decode_kernel_takes_a_token_major_q(cuda_device, dtype, tol, nq):
    """q as a [b, h, nq, d] view of [b, nq, h, d]: read in place, and the
    output written in the same layout."""
    q, *rest = decode_args(3, 2, nq, 1000, 64, dtype, [100, 0, 1000], False)
    q = token_major(q)
    out = decode_attn.decode_attention(q, *rest)
    ref = decode_attn.decode_attention_plain(q, *rest).to(dtype)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("nq,cap", [(1, 64), (1, 8192), (196, 384)])
def test_decode_launches_at_most_two_kernels(cuda_device, nq, cap):
    """The split kernel and, with more than one chunk, the merge: nothing
    else (q, token-major as the model hands it in, and the output stay in
    q's dtype and layout), counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    args = decode_args(2, 8, nq, cap, 64, torch.bfloat16, [cap, cap // 2], False)
    args = (token_major(args[0]), *args[1:])
    decode_attn.decode_attention(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            decode_attn.decode_attention(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    splits, _ = decode_attn.split_plan(2, 8, nq, cap, decode_attn._sm_count(0))
    assert len(kernels) == 4 * (1 if splits == 1 else 2), kernels


def test_kernel_wrappers_count_and_validate(cuda_device):
    q, k, v = (randn(1, 2, 64, 32, seed=s) for s in range(3))
    before = flash_attn.flash_attention.launches
    flash_attn.flash_attention(q, k, v, causal=True)
    assert flash_attn.flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="head dim"):
        flash_attn.flash_attention(*(randn(1, 2, 64, 48, seed=s) for s in range(3)), causal=True)
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q, k.to(torch.bfloat16), v, causal=True)
    with pytest.raises(ValueError, match="int8"):
        k8, _ = _quantize_rows(k)
        decode_attn.decode_attention(q, k8, k8, torch.zeros(1, 64, device=cuda_device))


def test_serving_on_card_matches_cpu(cuda_device):
    """One small float32 model on the card (CUDA kernels) and on the CPU
    (plain versions): greedy tokens equal, latents within 1e-3."""
    gm = Transfusion(device="cuda", seed=1, **CFG)
    cm = Transfusion(device="cpu", seed=1, **CFG)
    cm.core.load_state_dict({k: t.cpu() for k, t in gm.core.state_dict().items()})
    prompts = [np.asarray(p) for p in ([8, 1, 2], [8, 3, 4, 5, 6, 7], [8, 2])]
    kw = dict(max_new_tokens=6, temperature=0.0)
    assert torch.equal(gm.generate_text_batch(prompts, **kw).cpu(),
                       cm.generate_text_batch(prompts, **kw))
    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    skw = dict(prompt=[np.asarray([1, gm.som_ids[0]])], max_length=6, modality_steps=4,
               init_modality_noise=noise, text_temperature=0.0, cache_kv=True)
    lat_g = next(o[1] for o in gm.sample(**skw) if isinstance(o, tuple))
    lat_c = next(o[1] for o in cm.sample(**skw) if isinstance(o, tuple))
    np.testing.assert_allclose(lat_g, lat_c, atol=1e-3)


def assert_grads_close(got, want, rel):
    """Each gradient within rel of its reference's largest element: the two
    sides sum in another order and, in bf16, may round the output one ulp
    (2^-8 relative) apart."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(b.float().abs().max().item(), 1e-6)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * scale, f"{name}: {err} > {rel} * {scale}"


# 20 spans of 7 rows, 9 apart: many partial tiles, span edges inside tiles
SPANS20 = np.asarray([[[0, 3 + 9 * i, 7] for i in range(20)]] * 2, np.int32)


@pytest.mark.parametrize("spans_np", [SPANS, SPANS20], ids=["spans2", "spans20"])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,d", [(130, 32), (1000, 64), (200, 128), (300, 256)])
def test_backward_kernel_matches_plain(cuda_device, dtype, rel, n, d, spans_np):
    """Ragged n (no multiple of the 64-row tile), every head dim, offsets
    with kv_offset > q_offset (whole rows masked: dq exactly 0), an lse
    cotangent, 2 or 20 spans; bf16 on the tensor-core kernel, float32 on
    the FMA kernels."""
    q, k, v, do = (randn(2, 2, n, d, seed=s, dtype=dtype) for s in range(4))
    spans = torch.tensor(spans_np, device=cuda_device)
    g_lse = randn(2, 2, n, seed=9)
    for q_off, kv_off, gl in ((0, 0, None), (64, 16, g_lse), (0, 48, None)):
        out, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True, q_offset=q_off,
                                              kv_offset=kv_off, return_lse=True)
        before = flash_attn.flash_attention_backward.launches
        got = flash_attn.flash_attention_backward(q, k, v, out, lse, do, spans, 50.0, q_off,
                                                  kv_off, gl)
        assert flash_attn.flash_attention_backward.launches == before + 1
        delta = (do.float() * out.float()).sum(-1) - (0 if gl is None else gl)
        want = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, spans, 50.0,
                                                         q_off, kv_off)
        torch.cuda.synchronize()
        assert_grads_close(got, want, rel)
        if kv_off == 48:  # rows that see no column (causally or through a span): dq = 0
            dead = (~flash_attn.span_allowed(torch.arange(n, device=cuda_device),
                                             torch.arange(n, device=cuda_device) + 48,
                                             spans)).all(-1)  # [b, n]
            assert dead[:, :3].all()
            assert (got[0].permute(0, 2, 1, 3)[dead] == 0).all()


# the 4k training cell's rows: caption-image pairs, 256 latent rows an image
SPANS_4K = np.asarray([[[0, 40 + 700 * i, 256] for i in range(5)],
                       [[0, 900 + 1100 * i, 256] for i in range(3)] + [[0, 0, 0]] * 2], np.int32)


@pytest.mark.parametrize("dtype,tol,rel", [(torch.float32, 1e-4, 1e-4),
                                           (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("n,softcap", [(4096, 0.0), (4096, 50.0), (8192, 0.0)],
                         ids=["4k", "4k-softcap", "8k"])
def test_flash_kernels_at_qk_192_v_128_match_plain(cuda_device, dtype, tol, rel, n, softcap):
    """The (q k 192, value 128) pair of latent attention, forward and
    backward, at the 4k training cell's spans and at 8192 positions (its
    context), against the plain versions in 1024-row blocks; no padding:
    the output and dv are 128 wide."""
    b, h = (2, 2) if n == 4096 else (1, 2)
    q, k = (randn(b, h, n, 192, seed=s, dtype=dtype) for s in range(2))
    v, do = (randn(b, h, n, 128, seed=s, dtype=dtype) for s in range(2, 4))
    spans = torch.tensor(SPANS_4K[:b], device=cuda_device)
    out, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True, softcap=softcap,
                                          return_lse=True)
    assert out.shape == (b, h, n, 128)
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, spans, softcap, block_q=1024)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, do, spans, softcap)
    assert got[2].shape == v.shape and got[0].shape == q.shape
    delta = (do.float() * out.float()).sum(-1)
    want = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, spans, softcap,
                                                     block_q=1024)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    assert_grads_close(got, want, rel)


def test_pair_backward_with_collapsed_values_matches_plain(cuda_device):
    """The (192, 128) backward, bf16, where the values are one vector plus
    2^-5 of noise (as early training leaves them): dp - delta cancels to
    within its row's bound on a few % of the visible pairs, unevenly over
    the lanes of a warp tile, and those dp come from sequential products
    (the plain versions' rounding); gradients within 1e-2 of each largest
    element."""
    b, h, n = 1, 2, 1024
    q, k = (randn(b, h, n, 192, seed=s, dtype=torch.bfloat16) for s in range(2))
    base = randn(1, 1, 1, 128, seed=2) + 1.0
    v = (base + 2.0**-5 * randn(b, h, n, 128, seed=3)).to(torch.bfloat16)
    do = randn(b, h, n, 128, seed=4, dtype=torch.bfloat16)
    out, lse = flash_attn.flash_attention(q, k, v, causal=True, softcap=0.0, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    dp = do.float() @ v.float().transpose(-1, -2)
    bound = torch.maximum(2.0**-10 * delta.abs(), 2.0**-20 * do.float().norm(dim=-1)
                          * v.float().norm(dim=-1).amax(-1, keepdim=True))
    visible = torch.ones(n, n, device=cuda_device).tril().bool()
    cancel = ((dp - delta[..., None]).abs() < bound[..., None]) & visible
    share = cancel.sum().item() / (b * h * visible.sum().item())
    assert 0.005 < share < 0.2, share
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, do, None, 0.0)
    want = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, None, 0.0)
    torch.cuda.synchronize()
    assert_grads_close(got, want, 1e-2)


def test_flash_kernels_refuse_other_unequal_widths(cuda_device):
    q = randn(1, 2, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attn.flash_attention(q, q, randn(1, 2, 64, 64, dtype=torch.bfloat16), causal=True)
    assert flash_attn.supported(8192, 192, 128) and not flash_attn.supported(64, 192, 64)


def test_long_sequence_kernels_match_blocked_plain(cuda_device):
    """b1 h2 n12288 d64 bf16 with spans (the TPU's streamed envelope, rows 3
    and 9 of the kernel table) against the plain versions computed 2048
    query rows at a time: forward within 2e-2, dq/dk/dv within 1e-2 of
    each gradient's largest element; the launches count as rows 3 and 9."""
    b, h, n, d = 1, 2, 12288, 64
    q, k, v, do = (randn(b, h, n, d, seed=s, dtype=torch.bfloat16) for s in range(4))
    spans = torch.tensor([[[0, 600 + 804 * i, 196] for i in range(15)]], device=cuda_device)
    rows_f = dict(flash_attn.flash_attention.launches_by_row)
    rows_b = dict(flash_attn.flash_attention_backward.launches_by_row)
    out, lse = flash_attn.flash_attention(q, k, v, spans=spans, return_lse=True)
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, spans, block_q=2048)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, do, spans)
    delta = (do.float() * out.float()).sum(-1)
    want = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, spans,
                                                     block_q=2048)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert_grads_close(got, want, 1e-2)
    assert flash_attn.flash_attention.launches_by_row[3] == rows_f[3] + 1
    assert flash_attn.flash_attention_backward.launches_by_row[9] == rows_b[9] + 1


@pytest.mark.parametrize("dtype,tol,rel", [(torch.float32, 1e-4, 1e-4),
                                           (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("rope,n,d", [(True, 256, 64), (False, 256, 64), (True, 200, 128),
                                      (True, 128, 256)])
def test_token_major_kernels_match_plain(cuda_device, dtype, tol, rel, rope, n, d):
    b, h = 2, 4
    q, k, v, do = (randn(b, n, h * d, seed=s, dtype=dtype) for s in range(4))
    spans = torch.tensor([[[0, 40, 100]], [[0, 7, 196]]], device=cuda_device)
    cos = sin = None
    if rope:
        pos = torch.stack([torch.arange(n), torch.arange(n) // 3]).to(cuda_device)
        ang = rope_angles(pos, d)
        cos, sin = torch.cos(ang), torch.sin(ang)
    f = flash_attn_nhd
    before = (f.flash_attention_nhd.launches, f.flash_attention_nhd_backward.launches)
    out, lse = f._forward(q, k, v, h, cos, sin, spans, 50.0)
    ref, ref_lse = f.flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, 50.0)
    got = f.flash_attention_nhd_backward(q, k, v, out, lse, do, h, cos, sin, spans, 50.0)
    delta = (do.float() * out.float()).view(b, n, h, d).sum(-1).transpose(1, 2)
    want = f.flash_attention_nhd_backward_plain(q, k, v, do, lse, delta, h, cos, sin, spans,
                                                50.0)
    torch.cuda.synchronize()
    assert (f.flash_attention_nhd.launches, f.flash_attention_nhd_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert_grads_close(got, want, rel)


@pytest.mark.parametrize("n", [128, 300], ids=["token-major", "head-major"])
def test_head_dim_256_layer_on_card_matches_cpu(cuda_device, n):
    """One float32 `Attention(dim_head=256)` on the uncached flash route
    (token-major at n 128, head-major at n 300), forward and every
    parameter's gradient, on the card (kernels) and on the CPU (plain
    versions) from the same weights: within 1e-4 of max(1, the reference's
    largest element) (sums over 2 x n rows in another order)."""
    from transfusion_tpu_torch.models.layers import Attention

    wrapper = flash_attn_nhd.flash_attention_nhd if n == 128 else flash_attn.flash_attention
    before = wrapper.launches

    layers = [Attention(64, dim_head=256, heads=2, attn_impl="flash").to(dev)
              for dev in ("cuda", "cpu")]
    layers[1].load_state_dict({k: t.cpu() for k, t in layers[0].state_dict().items()})
    x = randn(2, n, 64, seed=5, device="cpu")
    spans = torch.tensor([[[0, 7, 40]], [[0, 30, 50]]])
    ang = rope_angles(torch.arange(n), 256)[None]
    out = []
    for layer in layers:
        dev = next(layer.parameters()).device
        xi = x.to(dev).requires_grad_(True)
        y = layer(xi, rope=ang.to(dev), flash_spec={"spans": spans.to(dev), "causal": True})[0]
        grads = torch.autograd.grad(y.square().sum(), [xi, *layer.parameters()])
        out.append([y.detach().cpu()] + [g.cpu() for g in grads])
    assert wrapper.launches == before + 1
    for a, b in zip(*out):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


def test_training_step_on_card_matches_cpu(cuda_device):
    """One float32 training step (token-major route: 2 heads x 64) on the
    card and on the CPU from the same weights and draws: loss and every
    gradient within 1e-4."""
    cfg = dict(CFG, transformer=dict(dim=64, depth=2, dim_head=64, heads=2, attn_impl="flash"))
    models = [Transfusion(device=dev, seed=2, **cfg) for dev in ("cuda", "cpu")]
    models[1].core.load_state_dict({k: t.cpu() for k, t in models[0].core.state_dict().items()})
    rng = np.random.default_rng(0)
    batch = [[rng.integers(0, 8, 5).astype(np.int32), rng.standard_normal((4, 16)).astype(np.float32)]
             for _ in range(3)]
    packed = models[1].pack(batch, shift_friendly=True).to_torch("cpu")
    draws = models[1].make_draws(packed, torch.Generator().manual_seed(0))
    out = []
    for m in models:
        dev = m.device
        p = packed.to_torch(dev) if dev.type == "cuda" else packed
        d = type(draws)(times=draws.times.to(dev), cfg_uniform=draws.cfg_uniform.to(dev),
                        noises=tuple(t.to(dev) for t in draws.noises))
        state = Trainer(m).init_state()
        leaves = {k: t.requires_grad_(True) for k, t in state.params.items()}
        loss, _ = m._loss_impl(leaves, p, d, m.prob_uncond)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        out.append((loss.item(), [None if g is None else g.cpu() for g in grads]))
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,tol,rel", [(torch.float32, 1e-4, 1e-4),
                                           (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("case", ["spans200", "bh65552"])
def test_flash_kernels_take_any_span_count_and_b_times_h(cuda_device, dtype, tol, rel, case):
    """Past the first versions' limits (128 spans a row, b * h 65535): 200
    spans a row (lengths 0-4, some rectangles overlapping causally), and
    b * h = 65536 + 16 at a small n; forward (out, lse) and backward
    against the plain versions."""
    if case == "spans200":
        b, h, n, d = 2, 2, 1024, 64
        spans = torch.tensor([[[0, 3 + 5 * i, (i + r) % 5] for i in range(200)] for r in range(b)],
                             device=cuda_device)
    else:
        b, h, n, d = 4097, 16, 40, 32
        spans = torch.tensor([[[0, 5, 10]]] * b, device=cuda_device)
    q, k, v, do = (randn(b, h, n, d, seed=s, dtype=dtype) for s in range(4))
    out, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True, return_lse=True)
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, spans)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, do, spans)
    delta = (do.float() * out.float()).sum(-1)
    want = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, spans)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert_grads_close(got, want, rel)


def near_cap_qk(b, h, n, d, seed=0):
    """q row i is +-45 d^-1/2 (k_i + k_{i-1}) (rows alternate) with keys of
    norm d^1/2: its logits q.k d^-1/2 on keys i and i - 1 are equal and
    near +-45, so the softmax of a + row splits between them (a one-hot
    softmax's dp - delta would cancel to rounding noise)."""
    k = randn(b, h, n, d, seed=seed)
    k = k / k.norm(dim=-1, keepdim=True) * d**0.5
    pair = k + torch.cat([torch.zeros_like(k[:, :, :1]), k[:, :, :-1]], 2)
    sign = 2.0 * (torch.arange(n, device="cuda") % 2) - 1.0
    return sign[:, None] * 45.0 * d**-0.5 * pair, k


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_backward_near_the_softcap_matches_plain(cuda_device, dtype, rel):
    """Logits near +-cap (|q.k| d^-1/2 in 35-60 at cap 50), where a 2^-11
    tanh would move the recomputed p by ~2 % against the forward's lse."""
    b, h, n, d = 2, 2, 300, 64
    q, k = (t.to(dtype) for t in near_cap_qk(b, h, n, d))
    v, do = (randn(b, h, n, d, seed=s, dtype=dtype) for s in (3, 4))
    logits = (q.float() * k.float()).sum(-1).abs() * d**-0.5  # each row on its own key
    assert ((logits > 35) & (logits < 60)).float().mean().item() > 0.9
    spans = torch.tensor(SPANS, device=cuda_device)
    out, lse = flash_attn.flash_attention(q, k, v, spans=spans, causal=True, return_lse=True)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, do, spans)
    delta = (do.float() * out.float()).sum(-1)
    want = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, spans)
    torch.cuda.synchronize()
    assert_grads_close(got, want, rel)


def pool_decode_args(nq, dtype, int8):
    """The decode call of sample_batch's pool: 2R = 16 rows, per-row write
    offsets idx, lens = idx + nq. Rows 0-7 are active (their new slots
    valid), rows 8-13 idle / non-members (their new slots masked invalid,
    below lens: the valid slots are not [0, lens)), row 14 also has a hole
    in its history, row 15 has no valid slot at all (output exactly 0)."""
    b, h, cap, d = 16, 8, 1152, 64
    idx = torch.tensor([37 + 55 * i for i in range(b)], dtype=torch.int32, device="cuda")
    lens = idx + nq
    slot = torch.arange(cap, device="cuda")[None, :]
    valid = slot < idx[:, None]
    valid[:8] = slot < lens[:8, None]
    valid[14, 10:30] = False
    valid[15] = False
    q = randn(b, h, nq, d, seed=11, dtype=dtype)
    k, v = (randn(b, h, cap, d, seed=s, dtype=dtype) for s in (12, 13))
    bias = torch.where(valid, 0.0, -1e30).float().contiguous()
    ks = vs = None
    if int8:
        k, ks = _quantize_rows(k)
        v, vs = _quantize_rows(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    return q, k, v, bias, ks, vs, 50.0, lens


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq", [1, 196])
def test_decode_kernel_at_the_pool_shapes_matches_plain(cuda_device, dtype, tol, int8, nq):
    """sample_batch's text ticks (nq 1) and grouped ODE (nq 196) over 16
    pool rows: idle and non-member rows come out finite, the row with no
    valid slot exactly 0."""
    args = pool_decode_args(nq, dtype, int8)
    q = token_major(args[0])  # as the model hands it in
    out = decode_attn.decode_attention(q, *args[1:])
    ref = decode_attn.decode_attention_plain(q, *args[1:]).to(dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out[15] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_uncached_sampling_on_card_matches_cpu(cuda_device):
    """Uncached sample() (the flash kernel on every joint forward) and
    generate_modality_only on the card against the CPU: greedy tokens
    equal, latents within 1e-3."""
    gm = Transfusion(device="cuda", seed=1, **CFG)
    cm = Transfusion(device="cpu", seed=1, **CFG)
    cm.core.load_state_dict({k: t.cpu() for k, t in gm.core.state_dict().items()})
    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, gm.som_ids[0]])], max_length=10, modality_steps=4,
              init_modality_noise=noise, text_temperature=0.0, cfg_scale=3.0)
    before = flash_attn.flash_attention.launches
    out_g = gm.sample(**kw)
    assert flash_attn.flash_attention.launches > before
    out_c = cm.sample(**kw)
    assert len(out_g) == len(out_c)
    for a, b in zip(out_g, out_c):
        if isinstance(a, tuple):
            np.testing.assert_allclose(a[1], b[1], atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b)
    lat = noise[:8].reshape(2, 4, 16)
    np.testing.assert_allclose(gm.generate_modality_only(noise=lat, modality_steps=4).cpu(),
                               cm.generate_modality_only(noise=lat, modality_steps=4), atol=1e-3)


def test_sample_batch_on_card_matches_cpu(cuda_device):
    """sample_batch over three requests on the card (flash prefill, decode
    ticks at nq 1 and the grouped ODE at nq 4 over 6 rows) against the CPU:
    tokens equal, latents within 1e-3."""
    gm = Transfusion(device="cuda", seed=1, **CFG)
    cm = Transfusion(device="cpu", seed=1, **CFG)
    cm.core.load_state_dict({k: t.cpu() for k, t in gm.core.state_dict().items()})
    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    prompts = [[np.asarray([1, 2, 3])], [np.asarray([4, gm.som_ids[0]])],
               (0, np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32))]
    kw = dict(max_length=8, modality_steps=4, init_modality_noise=noise, text_temperature=0.0,
              cfg_scale=3.0)
    before = decode_attn.decode_attention.launches
    out_g = gm.sample_batch(prompts, **kw)
    assert decode_attn.decode_attention.launches > before
    out_c = cm.sample_batch(prompts, **kw)
    for g, c in zip(out_g, out_c):
        assert len(g) == len(c)
        for a, b in zip(g, c):
            if isinstance(a, tuple):
                np.testing.assert_allclose(a[1], b[1], atol=1e-3)
            else:
                np.testing.assert_array_equal(a, b)


def test_sample_batch_chunk_fetches_to_the_host_once(cuda_device, monkeypatch):
    """Each text chunk runs its k decode steps with no synchronising call
    (CUDA sync debug mode 'error' raises on one) and is read back by one
    fetch; every tick launches the decode kernel once per layer."""
    from transfusion_tpu_torch.models import sample_batch as sb

    gm = Transfusion(device="cuda", seed=1, **CFG)
    log = []
    chunk, fetch = sb._chunk_tick_impl, sb._fetch

    def spy_chunk(*args, **kw):
        before = decode_attn.decode_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = chunk(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log.append(("chunk", kw["k"], decode_attn.decode_attention.launches - before))
        return out

    def spy_fetch(t):
        log.append(("fetch",))
        return fetch(t)

    monkeypatch.setattr(sb, "_chunk_tick_impl", spy_chunk)
    monkeypatch.setattr(sb, "_fetch", spy_fetch)
    gm.sample_batch([[np.asarray([1, 2, 3])], [np.asarray([5, 6])]], max_length=40,
                    text_temperature=1.0, cfg_scale=3.0, text_chunk=8)
    chunks = [i for i, e in enumerate(log) if e[0] == "chunk"]
    assert len(chunks) >= 2
    depth = CFG["transformer"]["depth"]
    for i in chunks:
        assert log[i + 1] == ("fetch",)
        assert log[i][2] == log[i][1] * depth  # one decode launch a layer and tick


def test_serving_engines_on_card_match_cpu(cuda_device):
    """Both continuous-batching engines on the card against the CPU, same
    weights: the text engine over 5 requests in 2 rows, one of which fills
    its 128-slot row exactly (tokens equal); the multimodal engine over a
    queue deeper than its pool and through a capacity rebuild (a 126-token
    [som] prompt in a 128-slot pool; tokens equal, latents within 1e-3).
    Both launch the flash and the decode kernel on the card."""
    from transfusion_tpu_torch.models.engine import ServingEngine
    from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine

    gm = Transfusion(device="cuda", seed=1, **CFG)
    cm = Transfusion(device="cpu", seed=1, **CFG)
    cm.core.load_state_dict({k: t.cpu() for k, t in gm.core.state_dict().items()})
    rng = np.random.default_rng(2)
    prompts = [[8] + rng.integers(0, 8, 99).tolist(), [8, 3, 4], [8, 5], [8, 6, 1], [8, 2]]
    budgets = [28, 40, 9, 7, 12]
    text = []
    for m in (gm, cm):
        eng = ServingEngine(m, max_batch=2, max_seq_len=128, decode_chunk=16, temperature=0.0)
        for p, b in zip(prompts, budgets):
            eng.submit(np.asarray(p, np.int32), b)
        before = (flash_attn.flash_attention.launches, decode_attn.decode_attention.launches)
        text.append({r.rid: r.tokens for r in eng.run()})
        if m is gm:
            assert flash_attn.flash_attention.launches > before[0]
            assert decode_attn.decode_attention.launches > before[1]
    assert text[0] == text[1]

    noise = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    mm_prompts = [[np.asarray([3] * 123 + [1, gm.som_ids[0]], np.int32)],
                  [np.asarray([1, 2, 3])], [np.asarray([4, gm.som_ids[0]])],
                  (0, np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32))]
    outs = []
    for m in (gm, cm):
        eng = MultimodalServingEngine(m, max_requests=2, max_seq_len=1, cfg_scale=3.0,
                                      modality_steps=4, text_temperature=0.0,
                                      init_modality_noise=noise)
        for p in mm_prompts:
            eng.submit(p, max_length=8)
        outs.append({f.rid: f.output for f in eng.run()})
        assert eng.stats["rebuilds"] >= 1
    for rid in outs[1]:
        g, c = outs[0][rid], outs[1][rid]
        assert len(g) == len(c)
        for a, b in zip(g, c):
            if isinstance(a, tuple):
                np.testing.assert_allclose(a[1], b[1], atol=1e-3)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_quantize", [False, True])
def test_graphed_engine_matches_eager_engine(cuda_device, monkeypatch, kv_quantize):
    """The text engine replaying its captured decode step against the same
    engine with its `DecodeGraph` left uncaptured (the step launched
    eagerly) on the card, same bf16 weights, over
    `test_serving_engines_on_card_match_cpu`'s five requests, bf16 and int8
    KV: tokens equal, and every tick's steps replayed from the graph."""
    from transfusion_tpu_torch.models import engine as engine_mod
    from transfusion_tpu_torch.models.engine import ServingEngine
    from transfusion_tpu_torch.training.metrics import MetricsLogger

    gm = Transfusion(device="cuda", seed=1, dtype=torch.bfloat16, **CFG)
    rng = np.random.default_rng(2)
    prompts = [[8] + rng.integers(0, 8, 99).tolist(), [8, 3, 4], [8, 5], [8, 6, 1], [8, 2]]
    budgets = [28, 40, 9, 7, 12]
    text, logs = [], []
    for graphed in (True, False):
        log = MetricsLogger()
        eng = ServingEngine(gm, max_batch=2, max_seq_len=128, decode_chunk=16,
                            temperature=0.0, kv_quantize=kv_quantize, metrics=log)
        for p, b in zip(prompts, budgets):
            eng.submit(np.asarray(p, np.int32), b)
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(engine_mod.DecodeGraph, "capture", lambda graph: None)
            text.append({r.rid: r.tokens for r in eng.run()})
        logs.append(log.history)
        assert eng.stats["generated_tokens"] == sum(budgets)
    assert text[0] == text[1]
    assert all(row["graph_steps"] == row["chunk_k"] for row in logs[0])
    assert all(row["graph_steps"] == 0 for row in logs[1])


def test_engine_chunks_fetch_to_the_host_once(cuda_device, monkeypatch):
    """Every chunk of both engines runs with no synchronising call (sync
    debug mode 'error') and is read back by one fetch; the text engine's
    chunk launches the decode kernel once a layer and step: each step is
    one replay of its captured step, whose capture recorded one decode
    launch a layer (the Python counter moves only at capture)."""
    from transfusion_tpu_torch.models import engine as engine_mod
    from transfusion_tpu_torch.models import sample_batch as sb
    from transfusion_tpu_torch.models.engine import ServingEngine
    from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine

    gm = Transfusion(device="cuda", seed=1, **CFG)
    log = []

    def watched(fn, k_of):
        def spy(*args, **kw):
            before = decode_attn.decode_attention.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log.append(("chunk", k_of(kw), decode_attn.decode_attention.launches - before))
            return out
        return spy

    fetch = sb._fetch

    def spy_fetch(t):
        log.append(("fetch",))
        return fetch(t)

    def watched_graph(fn):
        def spy(graph, active, left, gumbel, *, k):
            before = decode_attn.decode_attention.launches, graph.replays
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(graph, active, left, gumbel, k=k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log.append(("chunk", k, decode_attn.decode_attention.launches - before[0],
                        graph.replays - before[1], graph.decode_launches))
            return out
        return spy

    monkeypatch.setattr(engine_mod.DecodeGraph, "chunk",
                        watched_graph(engine_mod.DecodeGraph.chunk))
    monkeypatch.setattr(sb, "_chunk_tick_impl", watched(sb._chunk_tick_impl, lambda kw: kw["k"]))
    monkeypatch.setattr(sb, "_fetch", spy_fetch)
    eng = ServingEngine(gm, max_batch=2, max_seq_len=128, decode_chunk=8, temperature=1.0)
    eng.run([np.asarray([8, 1, 2]), np.asarray([8, 5, 6, 7]), np.asarray([8, 3])], 20)
    depth = CFG["transformer"]["depth"]
    chunks = [i for i, e in enumerate(log) if e[0] == "chunk"]
    assert len(chunks) >= 3
    for i in chunks:
        assert log[i + 1] == ("fetch",)
        _, k, launched, replays, recorded = log[i]
        assert launched == 0 and replays == k and recorded == depth
    log.clear()
    mm = MultimodalServingEngine(gm, max_requests=2, max_seq_len=256, text_temperature=1.0,
                                 cfg_scale=3.0, modality_steps=2, text_chunk=8)
    mm.run([[np.asarray([1, 2, 3])], [np.asarray([5, 6])], [np.asarray([4])]], max_length=24)
    chunks = [i for i, e in enumerate(log) if e[0] == "chunk"]
    assert len(chunks) >= 2
    for i in chunks:
        assert log[i + 1] == ("fetch",)


def image_model(device, seed=2):
    """A small float32 image model with every modality I/O option: patch
    encoder / decoder ([8, 8, 2] images <-> [4, 4, 8] latents), U-Net halves
    (2 x 2 = 4 rows a latent), axial pos-emb, reconstruction weight 0.1."""
    from transfusion_tpu_torch.models.modality_io import (
        PatchDecoder, PatchEncoder, SameConv2d, SameConvTranspose2d)

    torch.manual_seed(seed)  # the U-Net halves' weights
    return Transfusion(
        device=device, seed=seed, num_text_tokens=8, dim_latent=8, modality_default_shape=(4, 4),
        pad_multiple=16, modality_encoder=PatchEncoder(), modality_decoder=PatchDecoder(),
        pre_post_transformer_enc_dec=(SameConv2d(8, 64), SameConvTranspose2d(64, 8)),
        add_pos_emb=True, modality_num_dim=2, reconstruction_loss_weight=0.1,
        transformer=dict(dim=64, depth=2, dim_head=32, heads=2, attn_impl="flash"))


def image_pair():
    gm, cm = image_model("cuda"), image_model("cpu")
    cm.core.load_state_dict({k: t.cpu() for k, t in gm.core.state_dict().items()})
    return gm, cm


def test_image_model_step_on_card_matches_cpu(cuda_device):
    """One float32 step of the image model with the velocity term (EMA =
    the weights a little moved) on the card and on the CPU from the same
    draws: the loss, its velocity and reconstruction parts and every
    gradient within 1e-4."""
    gm, cm = image_pair()
    rng = np.random.default_rng(0)
    batch = [[rng.integers(0, 8, 5).astype(np.int32),
              (0, rng.uniform(size=(8, 8, 2)).astype(np.float32)),
              rng.integers(0, 8, 3).astype(np.int32)] for _ in range(3)]
    packed = cm.pack(cm.encode_modalities(batch), shift_friendly=True).to_torch("cpu")
    draws = cm.make_draws(packed, torch.Generator().manual_seed(0), velocity=True)
    out = []
    for m in (gm, cm):
        dev = m.device
        p = packed.to_torch(dev) if dev.type == "cuda" else packed
        d = type(draws)(times=draws.times.to(dev), cfg_uniform=draws.cfg_uniform.to(dev),
                        noises=tuple(t.to(dev) for t in draws.noises),
                        ema_noises=tuple(t.to(dev) for t in draws.ema_noises))
        state = Trainer(m).init_state()
        leaves = {k: t.requires_grad_(True) for k, t in state.params.items()}
        ema = {k: t + 0.01 * torch.ones_like(t) for k, t in state.params.items()}
        loss, bd = m._loss_impl(leaves, p, d, m.prob_uncond, ema_params=ema)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append(([loss.item(), bd.velocity[0].item(), bd.recon[0].item()],
                    [g.cpu() for g in grads]))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-4)
    for a, b in zip(out[0][1], out[1][1]):
        assert (a - b).abs().max().item() <= 1e-4


def test_image_model_cached_sample_on_card_matches_cpu(cuda_device):
    """The image model's cached sample() with CFG 3.0 (flash prefill,
    decode at nq 1 and at the U-Net's 4 rows): greedy tokens equal,
    latents and decoded images within 1e-3."""
    gm, cm = image_pair()
    noise = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, gm.som_ids[0]])], max_length=10, modality_steps=4,
              init_modality_noise=noise, text_temperature=0.0, cfg_scale=3.0, cache_kv=True)
    for raw in (True, False):
        out_g = gm.sample(return_unprocessed_modalities=raw, **kw)
        out_c = cm.sample(return_unprocessed_modalities=raw, **kw)
        assert len(out_g) == len(out_c)
        for a, b in zip(out_g, out_c):
            if isinstance(a, tuple):
                assert a[1].shape == ((4, 4, 8) if raw else (8, 8, 2))
                np.testing.assert_allclose(a[1], b[1], atol=1e-3)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_decode_kernel_at_the_unet_rows_matches_plain(cuda_device, dtype, tol):
    """The grouped ODE of a U-Net image model: nq 49 (7 x 7 rows of a 14 x 14
    latent) over 16 pool rows, the `decode_mma` path in bf16."""
    args = pool_decode_args(49, dtype, False)
    q = token_major(args[0])
    out = decode_attn.decode_attention(q, *args[1:])
    ref = decode_attn.decode_attention_plain(q, *args[1:]).to(dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[15] == 0).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def laser_values(t):
    """LASER's attention values exp(softclamp(v, 15)), up to e^15."""
    return torch.exp(torch.tanh(t.float() / 15.0) * 15.0).to(t.dtype)


def row_rel_err(out, ref):
    """Each row's largest error over that row's RMS (the reference's)."""
    err = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return (err / rms).max().item()


@pytest.mark.parametrize("dtype,tol,row,rel", [(torch.float32, 1e-4, 1e-3, 1e-4),
                                               (torch.bfloat16, 2e-2, 0.08, 1e-2)])
def test_laser_values_through_the_flash_kernels_match_plain(cuda_device, dtype, tol, row, rel):
    """LASER's exp-space values (v ~ 6 N(0, 1) through softclamp 15, so up
    to ~3e6) through row 1 (head-major forward, 8 small heads), row 5 and
    row 6 (token-major forward and backward with RoPE): every output row
    within `row` of its RMS, the outputs after safe_log within the model's
    tolerance, and the backward, under safe_log's cotangent do = g / out,
    within `rel` of each gradient's largest element."""
    spans = torch.tensor([[[0, 3, 30]], [[0, 10, 40]]], device=cuda_device)
    # row 1: the head-major forward, as a LASER sample() prefill gives it
    q, k = (randn(2, 8, 64, 64, seed=s, dtype=dtype) for s in (1, 2))
    v = laser_values(randn(2, 8, 64, 64, seed=3, dtype=dtype) * 6)
    assert flash_attn.tpu_row(8, 64, 64, 64, bwd=False) == 1
    out = flash_attn.flash_attention(q, k, v, spans=spans, causal=True)
    ref, _ = flash_attn.flash_attention_plain(q, k, v, spans, 50.0)
    torch.cuda.synchronize()
    assert v.float().max().item() > 1e5
    assert row_rel_err(out, ref) <= row
    log_err = (torch.log(out.float().clamp_min(1e-20)) - torch.log(ref.float().clamp_min(1e-20)))
    assert log_err.abs().max().item() <= tol
    # rows 5 and 6: the token-major route of the training step
    b, n, h, d = 2, 256, 4, 64
    q, k, g = (randn(b, n, h * d, seed=s, dtype=dtype) for s in (4, 5, 6))
    v = laser_values(randn(b, n, h * d, seed=7, dtype=dtype) * 6)
    ang = rope_angles(torch.arange(n, device=cuda_device), d)[None].expand(b, n, d)
    cos, sin = torch.cos(ang), torch.sin(ang)
    f = flash_attn_nhd
    out, lse = f._forward(q, k, v, h, cos, sin, spans, 50.0)
    ref, _ = f.flash_attention_nhd_plain(q, k, v, h, cos, sin, spans, 50.0)
    do = (g.float() / out.float().clamp_min(1e-20)).to(dtype)
    got = f.flash_attention_nhd_backward(q, k, v, out, lse, do, h, cos, sin, spans, 50.0)
    delta = (do.float() * out.float()).view(b, n, h, d).sum(-1).transpose(1, 2)
    want = f.flash_attention_nhd_backward_plain(q, k, v, do, lse, delta, h, cos, sin, spans,
                                                50.0)
    torch.cuda.synchronize()
    assert row_rel_err(out, ref) <= row
    log_err = (torch.log(out.float().clamp_min(1e-20)) - torch.log(ref.float().clamp_min(1e-20)))
    assert log_err.abs().max().item() <= tol
    assert_grads_close(got, want, rel)


def test_laser_streams_muon_model_on_card_matches_cpu(cuda_device):
    """The phase-3 model of chip_smoke.py (float32, LASER, 4 residual
    streams, fused projections) on the card and on the CPU from the same
    weights and draws: one `Trainer(optimizer=muon_adam_atan2(...))` step's
    loss and every gradient within 1e-4 and the new parameters (Muon's bf16
    Newton-Schulz rounds apart on the two devices: its matrices within 0.5
    of their change's Frobenius norm; the Adam-atan2 rest within 1e-5 but
    for entries whose ~0 gradient takes its sign from rounding, at most
    0.1 % of them, each within 4 lr); then cached `sample` (CFG 3.0):
    tokens equal, latents within 1e-3, no decode launch."""
    from transfusion_tpu_torch.training import muon_adam_atan2

    cfg = dict(CFG, transformer=dict(dim=64, depth=2, dim_head=64, heads=2, attn_impl="flash",
                                     attn_laser=True, num_residual_streams=4,
                                     fuse_projections=True))
    models = [Transfusion(device=dev, seed=2, **cfg) for dev in ("cuda", "cpu")]
    models[1].core.load_state_dict({k: t.cpu() for k, t in models[0].core.state_dict().items()})
    rng = np.random.default_rng(0)
    batch = [[rng.integers(0, 8, 5).astype(np.int32),
              rng.standard_normal((4, 16)).astype(np.float32)] for _ in range(3)]
    packed = models[1].pack(batch, shift_friendly=True).to_torch("cpu")
    draws = models[1].make_draws(packed, torch.Generator().manual_seed(0))
    out = []
    for m in models:
        dev = m.device
        d = type(draws)(times=draws.times.to(dev), cfg_uniform=draws.cfg_uniform.to(dev),
                        noises=tuple(t.to(dev) for t in draws.noises))
        tr = Trainer(m, optimizer=muon_adam_atan2(3e-4, 3e-4))
        state = tr.init_state()
        loss, _, grads = tr._grads(state, packed.to_torch(dev), d)
        new, _ = tr._apply(state, grads, loss, {}, 0)
        out.append((loss.item(), {k: g.cpu() for k, g in grads.items()},
                    {k: p.cpu() for k, p in new.params.items()},
                    {k: p.cpu() for k, p in state.params.items()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    muon = set(models[1].muon_parameters())
    flips = total = 0
    for k, g in out[1][1].items():
        assert (out[0][1][k] - g).abs().max().item() <= 1e-4, k
        diff = out[0][2][k] - out[1][2][k]
        if k in muon:
            assert diff.norm().item() <= 0.5 * (out[1][2][k] - out[1][3][k]).norm().item(), k
        else:
            assert diff.abs().max().item() <= 4 * 3e-4, k
            flips += int((diff.abs() > 1e-5).sum())
            total += diff.numel()
    assert flips <= 1e-3 * total
    noise = np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32)
    before = decode_attn.decode_attention.launches
    kw = dict(prompt=[np.asarray([3, models[0].som_ids[0]])], max_length=20, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0, cache_kv=True)
    got, want = (m.sample(**kw) for m in models)
    assert decode_attn.decode_attention.launches == before
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert np.abs(a[1] - b[1]).max() <= 1e-3
        else:
            assert np.array_equal(a, b)


def test_grouped_experts_match_the_expert_loop(cuda_device):
    """The expert layer on the card in bf16 (assignments sorted on the
    device, grouped GEMMs, gathers back) against the CPU's loop over the
    experts in float32 on the same weights, inputs and routing: the output
    and the gradients of the input and of the experts' weights within 2e-2
    of each one's largest element; the same bits on a second run (no
    atomics); the held assignments counted on the device. The CPU's router
    chooses as the card's for all but near-tied tokens."""
    from transfusion_tpu_torch.models.moonlight import MoE

    torch.manual_seed(0)
    cpu = MoE(256, experts=16, held=8, top_k=4, inner=128, shared=2, scale=2.446)
    with torch.no_grad():
        cpu.gate.e_score_correction_bias.normal_(std=0.05)
    card = MoE(256, experts=16, held=8, top_k=4, inner=128, shared=2, scale=2.446).to("cuda")
    card.load_state_dict(cpu.state_dict())
    card = card.to(torch.bfloat16)
    card.gate.float()
    x = randn(2, 300, 256, seed=5).to(torch.bfloat16)
    g = randn(2, 300, 256, seed=6).to(torch.bfloat16)
    with torch.no_grad():  # the CPU side computes from the card's bf16 values
        for (_, p), (_, q) in zip(cpu.named_parameters(), card.named_parameters()):
            p.copy_(q.float())
    choice, weight = card.gate(x.reshape(600, 256))
    cpu_choice, _ = cpu.gate(x.float().cpu().reshape(600, 256))
    agree = (cpu_choice.sort(-1).values == choice.cpu().sort(-1).values).all(-1)
    assert agree.float().mean() >= 0.98
    card.gate.forward = lambda t: (choice, weight)  # one routing for both sides
    cpu.gate.forward = lambda t: (choice.cpu(), weight.cpu())
    leaves = ("experts.gate_up_proj", "experts.down_proj", "shared_experts.gate_proj.weight",
              "shared_experts.up_proj.weight", "shared_experts.down_proj.weight")

    def run(model, x, g):
        x = x.detach().requires_grad_(True)
        out = model(x)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(out, [x, *(params[k] for k in leaves)], g)
        return out.detach(), grads

    got, got_g = run(card, x, g)
    again, again_g = run(card, x, g)
    want, want_g = run(cpu, x.float().cpu(), g.float().cpu())
    torch.cuda.synchronize()
    assert torch.equal(got, again) and all(torch.equal(a, b) for a, b in zip(got_g, again_g))
    for a, b in zip((got, *got_g), (want, *want_g)):
        scale = b.abs().max().item()
        assert (a.float().cpu() - b).abs().max().item() <= 2e-2 * scale
    assert card.expert_load.cpu().tolist() == (2 * cpu.expert_load).tolist()  # two runs
