"""PyTorch port on a CUDA card: each CUDA kernel against its plain PyTorch
version, and the serving path on the card against the same weights on the
CPU. Every test here is marked `cuda` and skips without a GPU (the CUDA
kernels have no CPU mode). This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.layers import _quantize_rows
from transfusion_tpu_torch.ops import decode_attn, flash_attn

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
