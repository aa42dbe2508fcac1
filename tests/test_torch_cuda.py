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
@pytest.mark.parametrize("n,d", [(130, 32), (1000, 64), (200, 128)])
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
@pytest.mark.parametrize("n,d", [(130, 32), (1000, 64), (200, 128)])
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
    wide = torch.empty(2, 32768, 8, d, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid rows"):
        flash_attn.flash_attention(wide, wide, wide, causal=True)


@pytest.mark.parametrize("dtype,tol,rel", [(torch.float32, 1e-4, 1e-4),
                                           (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("rope,n,d", [(True, 256, 64), (False, 256, 64), (True, 200, 128)])
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
