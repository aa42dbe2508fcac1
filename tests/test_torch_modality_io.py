"""PyTorch port: a modality's input and output against the JAX package, in
float32 on the CPU: the axial position embedding (`ops/axial.py`), the
torch twins of flax's `SAME` conv and transposed conv
(`models/modality_io.py`), `weights.from_flax` with position-embedding MLPs
and delegated U-Net subtrees, `seq_shape_for` and the packer's spans, the
encoder / decoder forms of `norm_aux`, and a model with a patch encoder and
decoder, a U-Net `pre_post_transformer_enc_dec` pair and `add_pos_emb`
through the joint loss (every gradient), cached and uncached `sample`,
`generate_modality_only`, `sample_batch` and `MultimodalServingEngine`.

The JAX side runs with `attn_impl="dense"` (its dense and flash routes
agree to float32 rounding; tests/test_torch_sample_batch.py), the port on
its flash route (the plain versions on the CPU). Same weights through
`from_flax`, same draws (JAX's key schedule, handed over as numpy).
Tolerances: 1e-6 for the embedding MLP, 1e-5 for the convolutions, 1e-4
for losses and gradients, 2e-5 for fixed-grid latents and decoded images;
greedy tokens equal."""

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from einops import rearrange

from transfusion_tpu.models.engine_mm import MultimodalServingEngine as JaxEngine
from transfusion_tpu.models.sample_batch import sample_batch as j_sample_batch
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.ops.axial import ContinuousAxialPositionalEmbedding as JaxAxial
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine
from transfusion_tpu_torch.models.modality_io import (
    PatchDecoder,
    PatchEncoder,
    SameConv2d,
    SameConvTranspose2d,
)
from transfusion_tpu_torch.ops.axial import ContinuousAxialPositionalEmbedding
from transfusion_tpu_torch.weights import from_flax

from test_torch_training import draws_from_key

torch.set_num_threads(1)

DIM, D_LAT = 32, 8  # images [12, 12, 2] -> latents [6, 6, 8] -> 3 x 3 = 9 rows
IMG, LAT, SEQ = (12, 12, 2), (6, 6), (3, 3)
CFG = dict(num_text_tokens=16, dim_latent=D_LAT, modality_default_shape=LAT, pad_multiple=16,
           add_pos_emb=True, modality_num_dim=2, reconstruction_loss_weight=0.1,
           prob_uncond=0.5)
PIN_NOISE = np.asarray(np.random.default_rng(7).normal(size=(36, D_LAT)), np.float32)


def tcfg(attn_impl):
    return dict(dim=DIM, depth=2, dim_head=32, heads=2, attn_impl=attn_impl)


# the JAX package's modules (the examples' patch codec, with a channel axis,
# and the U-Net halves of tests/test_transfusion.py)
class JPatchEncoder(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return rearrange(x, "... (h p1) (w p2) c -> ... h w (p1 p2 c)", p1=2, p2=2) * 2 - 1


class JPatchDecoder(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = rearrange(x, "... h w (p1 p2 c) -> ... (h p1) (w p2) c", p1=2, p2=2)
        return ((x + 1) * 0.5).clip(0.0, 1.0)


class Down(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(self.features, (3, 3), strides=(2, 2), padding="SAME")(x)


class Up(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(self.features, (3, 3), strides=(2, 2), padding="SAME")(x)


def jax_model(**kw):
    return JaxTransfusion(transformer=tcfg("dense"), modality_encoder=JPatchEncoder(),
                          modality_decoder=JPatchDecoder(),
                          pre_post_transformer_enc_dec=(Down(DIM), Up(D_LAT)), **CFG, **kw)


def port_model(params, **kw):
    tm = Transfusion(transformer=tcfg("flash"), modality_encoder=PatchEncoder(),
                     modality_decoder=PatchDecoder(),
                     pre_post_transformer_enc_dec=(SameConv2d(D_LAT, DIM),
                                                   SameConvTranspose2d(DIM, D_LAT)),
                     device="cpu", **CFG, **kw)
    return tm.load_flax(jax.tree.map(np.asarray, params))


def jitter(params, seed=42, scale=0.05):
    key = jax.random.PRNGKey(seed)

    def f(path, p):
        nonlocal key
        key, k = jax.random.split(key)
        return p + jax.random.normal(k, p.shape) * scale

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def models():
    jm = jax_model()
    params = jitter(jm.init_params(jax.random.PRNGKey(0)))
    jm.params = params
    return jm, params, port_model(params)


def images(rng, k):
    return rng.uniform(0.0, 1.0, (k, *IMG)).astype(np.float32)


def samples(seed=0):
    """Three samples of raw images: text + image + text, text alone, and an
    image alone."""
    rng = np.random.default_rng(seed)
    return [
        [rng.integers(0, 16, 5).astype(np.int32), (0, images(rng, 1)[0]),
         rng.integers(0, 16, 3).astype(np.int32)],
        [rng.integers(0, 16, 9).astype(np.int32)],
        [(0, images(rng, 1)[0])],
    ]


def assert_items(got, want, atol=2e-5):
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert isinstance(b, tuple) and a[0] == b[0]
            assert np.asarray(a[1]).shape == np.asarray(b[1]).shape
            np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=atol)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- leaves --------------------------------------------------------------------


@pytest.mark.parametrize("shape,nd", [((), 2), ((5,), 2), ((3, 4), 2), ((2, 3, 4), 3)])
def test_axial_pos_emb_matches_jax(shape, nd):
    coords_j = np.asarray(JaxAxial.coords_for_shape(shape, nd))
    coords_t = ContinuousAxialPositionalEmbedding.coords_for_shape(shape, nd)
    np.testing.assert_array_equal(coords_t.numpy(), coords_j)
    mlp_j = JaxAxial(dim=16, num_axial_dims=nd)
    p = mlp_j.init(jax.random.PRNGKey(1), coords_j)["params"]
    mlp_t = ContinuousAxialPositionalEmbedding(16, nd)
    mlp_t.load_state_dict({f"layers.{j}.{n}": torch.tensor(np.asarray(
        p[f"Dense_{j}"][k]).T.copy() if k == "kernel" else np.asarray(p[f"Dense_{j}"][k]))
        for j in range(3) for k, n in (("kernel", "weight"), ("bias", "bias"))})
    out_j = np.asarray(mlp_j.apply({"params": p}, coords_j))
    np.testing.assert_allclose(mlp_t(coords_t).detach().numpy(), out_j, atol=1e-6)


@pytest.mark.parametrize("size,k,s", [(14, 3, 2), (7, 3, 2), (6, 3, 2), (9, 4, 2), (5, 3, 1)])
def test_conv_twins_match_flax(size, k, s):
    """flax `SAME` pads a k3 s2 conv on 14 (0, 1), and its transposed conv
    correlates the dilated input with the kernel unflipped over (2, 1)."""
    x = np.random.default_rng(size).standard_normal((2, size, size, 4)).astype(np.float32)
    for flax_mod, twin in ((fnn.Conv(6, (k, k), strides=(s, s), padding="SAME"),
                            SameConv2d(4, 6, k, s)),
                           (fnn.ConvTranspose(6, (k, k), strides=(s, s), padding="SAME"),
                            SameConvTranspose2d(4, 6, k, s))):
        p = flax_mod.init(jax.random.PRNGKey(size), x)
        want = np.asarray(flax_mod.apply(p, x))
        twin.load_state_dict(twin.from_flax(jax.tree.map(np.asarray, p["params"])))
        got = twin(torch.tensor(x)).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_patch_codec_matches_jax():
    x = images(np.random.default_rng(0), 3)
    lat_j = np.asarray(JPatchEncoder().apply({}, x))
    lat_t = PatchEncoder()(torch.tensor(x))
    np.testing.assert_array_equal(lat_t.numpy(), lat_j)
    np.testing.assert_array_equal(PatchDecoder()(lat_t).numpy(),
                                  np.asarray(JPatchDecoder().apply({}, lat_j)))
    np.testing.assert_allclose(PatchDecoder()(lat_t).numpy(), x, atol=1e-6)


# -- weights, shapes, packing ----------------------------------------------------


def test_from_flax_maps_pos_emb_and_delegates_unet(models):
    jm, params, tm = models
    sd = from_flax(jax.tree.map(np.asarray, params), tm)
    assert "pos_emb_mlps.0.layers.2.weight" in sd and "latent_to_model.0.conv.weight" in sd
    tree = params["params"]
    np.testing.assert_array_equal(sd["pos_emb_mlps.0.layers.1.weight"].numpy(),
                                  np.asarray(tree["pos_emb_mlps_0"]["Dense_1"]["kernel"]).T)
    # the delegated subtree: HWIO -> OIHW, and the transposed conv's kernel flipped
    np.testing.assert_array_equal(
        sd["latent_to_model.0.conv.weight"].numpy(),
        np.asarray(tree["pre_post_enc_dec_0_0"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["model_to_latent.0.conv.weight"].numpy(),
        np.asarray(tree["pre_post_enc_dec_0_1"]["ConvTranspose_0"]["kernel"])[::-1, ::-1]
        .transpose(2, 3, 0, 1))
    # the port's state_dict holds the projections and the MLP (Trainer masters)
    assert set(sd) == set(tm.core.state_dict())


def test_from_flax_refuses_unmapped_conv_kernels(models):
    _, params, _ = models
    flat = jax.tree.map(np.asarray, params)
    # default projections: the U-Net's 4-D kernels have no module to map them
    plain = Transfusion(transformer=tcfg("flash"), device="cpu", **CFG)
    with pytest.raises(ValueError, match="rank-4 kernel"):
        from_flax(flat, plain)

    class NoFromFlax(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(D_LAT, DIM, 3, stride=2)

        def forward(self, x):
            return self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    custom = Transfusion(transformer=tcfg("flash"), device="cpu",
                         pre_post_transformer_enc_dec=(NoFromFlax(),
                                                       SameConvTranspose2d(DIM, D_LAT)), **CFG)
    with pytest.raises(ValueError, match="without a from_flax"):
        from_flax(flat, custom)


def test_seq_shape_and_packed_spans_match_jax(models):
    """14 x 14 latents through the stride-2 Down: 49 rows a span, and the
    meta string keeps the latent shape (JAX
    `test_modality_only_with_unet_downsample`)."""
    jm, _, tm = models
    assert tm.seq_shape_for(0, (14, 14)) == jm.seq_shape_for(0, (14, 14)) == (7, 7)
    assert tm.seq_shape_for(0, LAT) == SEQ and tm.seq_len_for(0, (14, 14)) == 49
    rng = np.random.default_rng(3)
    batch = [[np.asarray([1, 2], np.int32), (0, rng.standard_normal((14, 14, D_LAT))
                                                .astype(np.float32))],
             [(0, rng.standard_normal((*LAT, D_LAT)).astype(np.float32)),
              np.asarray([5], np.int32)]]
    pj, pt = jm.pack(batch), tm.pack(batch)
    for f in ("text", "cfg_mask", "spans", "lengths", "total_tokens"):
        np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)), err_msg=f)
    assert pt.spans[0, 0, 2] == 49 and pt.spans[1, 0, 2] == 9
    meta = [chr(c - tm.char_offset) for c in pt.text[0] if tm.char_offset <= c < tm.vocab_size]
    assert "".join(meta) == "14,14"
    assert [g.seq_shape for g in pt.groups] == [g.seq_shape for g in pj.groups]


def test_encoder_decoder_forms():
    """norm_aux: a module for every modality, a (module, state_dict) pair,
    a per-modality list with None, and (Enc(), None) with two modalities
    read as that list, with a warning (JAX
    `test_per_modality_encoder_list_with_none`)."""

    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(2.0))

        def forward(self, x):
            return x * self.w

    two = dict(num_text_tokens=8, dim_latent=(4, 8), modality_default_shape=((2,), (2,)),
               transformer=dict(dim=16, depth=1, dim_head=8, heads=2), pad_multiple=8,
               device="cpu")
    enc = Scale()
    with pytest.warns(UserWarning, match="per-modality list"):
        m = Transfusion(modality_encoder=(enc, None), **two)
    assert m.encoders[0] is not None and m.encoders[1] is None
    assert m.encoders[0] is not enc and not m.encoders[0].training
    assert not any(p.requires_grad for p in m.encoders[0].parameters())
    x = np.ones((2, 4), np.float32)
    out = m.encode_modalities([[(0, x), (1, np.ones((2, 8), np.float32))]])
    np.testing.assert_array_equal(out[0][0][1], 2 * x)
    np.testing.assert_array_equal(out[0][1][1], np.ones((2, 8)))
    # a pair with its own state_dict, and one module for both modalities
    m = Transfusion(modality_encoder=[(Scale(), {"w": torch.tensor(3.0)})], **two)
    assert float(m.encoders[0].w) == 3.0 and float(m.encoders[1].w) == 3.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m = Transfusion(modality_encoder=Scale(), **two)
    assert all(e is not None for e in m.encoders) and m.encoders[0] is not m.encoders[1]
    # the encoders live outside the trainable parameters
    assert not any("w" == k.split(".")[-1] for k in m.parameters_without_encoder_decoder())
    with pytest.raises(ValueError, match="3 encoders/decoders for 2 modalities"):
        Transfusion(modality_encoder=[Scale(), Scale(), Scale()], **two)


# -- the image model -----------------------------------------------------------


def test_joint_loss_and_grads_match_jax(models):
    """Encoder + U-Net + pos-emb + reconstruction: the loss, its parts and
    every gradient, the U-Net halves' and the MLP's included. Key 3 draws
    times 0.38 and 0.13 and drops one sample's text; near t = 1 the
    x-prediction's 1 / (1 - t) scales the loss into the hundreds, where
    float32 rounding alone passes an absolute 1e-4."""
    jm, params, tm = models
    enc_j = jm.encode_modalities(samples())
    packed = jm.pack(enc_j, shift_friendly=True)
    rng = jax.random.PRNGKey(3)
    draws = draws_from_key(rng, packed)

    def jloss(p):
        return jm._loss_impl(p, jax.tree.map(jnp.asarray, packed), rng, None, None,
                             prob_uncond=0.5, velocity_delta=1e-3, train=True)

    (total_j, bd_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.core.named_parameters()}
    packed_t = tm.pack(tm.encode_modalities(samples()), shift_friendly=True)
    np.testing.assert_array_equal(packed_t.spans, np.asarray(packed.spans))
    total_t, bd_t = tm._loss_impl(leaves, packed_t.to_torch("cpu"), draws, 0.5)
    grads_t = torch.autograd.grad(total_t, list(leaves.values()))
    np.testing.assert_allclose(total_t.item(), float(total_j), atol=1e-4)
    np.testing.assert_allclose(bd_t.text.item(), float(bd_j.text), atol=1e-4)
    np.testing.assert_allclose(bd_t.flow[0].item(), float(bd_j.flow[0]), atol=1e-4)
    assert bd_t.velocity is None and bd_j.velocity is None
    np.testing.assert_allclose(bd_t.recon[0].item(), float(bd_j.recon[0]), atol=1e-4)
    want = from_flax(jax.tree.map(np.asarray, grads_j), tm)
    for k, g in zip(leaves, grads_t):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    # loss() encodes the ragged batch itself
    total = tm.loss(samples(), draws=draws, prob_uncond=0.5)
    np.testing.assert_allclose(float(total), total_t.item(), atol=1e-6)


@pytest.mark.parametrize("cache_kv", [False, True])
@pytest.mark.parametrize("prompt_kind", ["image", "som"])
def test_sample_matches_jax(models, cache_kv, prompt_kind):
    """A raw-image prompt (encoded), or text ending in [som] (an image
    sampled at once: 9 sequence rows), greedy text, CFG 3.0, pinned noise:
    the same tokens, the same latents (2e-5) and the same decoded images."""
    jm, params, tm = models
    prompt = ((0, images(np.random.default_rng(4), 1)[0]) if prompt_kind == "image"
              else [np.asarray([3, 1, tm.som_ids[0]], np.int32)])
    kw = dict(max_length=14, text_temperature=0.0, text_min_p=0.0, modality_steps=3,
              init_modality_noise=PIN_NOISE, cfg_scale=3.0, cache_kv=cache_kv)
    raw_j = jm.sample(params, prompt, rng=jax.random.PRNGKey(1),
                      return_unprocessed_modalities=True, **kw)
    raw_t = tm.sample(prompt, return_unprocessed_modalities=True, **kw)
    assert_items(raw_t, raw_j)
    out_t = tm.sample(prompt, **kw)
    assert_items(out_t, jm.sample(params, prompt, rng=jax.random.PRNGKey(1), **kw))
    lats = [o[1] for o in raw_t if isinstance(o, tuple)]
    decoded = [o[1] for o in out_t if isinstance(o, tuple)]
    assert lats and all(x.shape == (*LAT, D_LAT) for x in lats)
    assert all(d.shape == IMG and d.min() >= 0.0 and d.max() <= 1.0 for d in decoded)
    np.testing.assert_array_equal(decoded[-1], tm.decode_modalities([(0, lats[-1])])[0][1])


def test_generate_modality_only_matches_jax(models):
    jm, params, tm = models
    rng = jax.random.PRNGKey(2)
    out_j = jm.generate_modality_only(params, batch_size=2, rng=rng, modality_steps=3)
    raw_j = jm.generate_modality_only(params, batch_size=2, rng=rng, modality_steps=3,
                                      return_unprocessed_modalities=True)
    noise = np.asarray(jax.random.normal(rng, (2, *LAT, D_LAT)))
    out_t = tm.generate_modality_only(noise=noise, modality_steps=3)
    raw_t = tm.generate_modality_only(noise=noise, modality_steps=3,
                                      return_unprocessed_modalities=True)
    assert out_t.shape == (2, *IMG) and raw_t.shape == (2, *LAT, D_LAT)
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=2e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)


def test_sample_batch_and_engine_match_jax(models):
    """`sample_batch` and the multimodal engine over an image prompt, a
    [som] prompt and a text prompt: the JAX package's decoded outputs."""
    jm, params, tm = models
    rng = np.random.default_rng(5)
    prompts = [(0, images(rng, 1)[0]), [np.asarray([3, 1, tm.som_ids[0]], np.int32)],
               [rng.integers(0, 16, 4).astype(np.int32)]]
    kw = dict(max_length=13, text_temperature=0.0, text_min_p=0.0, modality_steps=3,
              init_modality_noise=PIN_NOISE, cfg_scale=3.0)
    want = j_sample_batch(jm, params, prompts, rng=jax.random.PRNGKey(1), **kw)
    got = tm.sample_batch(prompts, **kw)
    for g, w in zip(got, want):
        assert_items(g, w)
    assert any(isinstance(o, tuple) and o[1].shape == IMG for o in got[1])

    ekw = dict(kw)
    max_length = ekw.pop("max_length")
    eng = MultimodalServingEngine.for_workload(tm, prompts, max_length, max_requests=2, **ekw)
    rids = [eng.submit(p, max_length=max_length) for p in prompts]
    done = {f.rid: f for f in eng.run()}
    je = JaxEngine.for_workload(jm, params, prompts, max_length, max_requests=2,
                                rng=jax.random.PRNGKey(1), **ekw)
    for p in prompts:
        je.submit(p, max_length=max_length)
    want_e = {f.rid: f.output for f in je.run()}
    for rid in rids:
        assert_items(done[rid].output, want_e[rid])
        assert_items(done[rid].output, got[rid])
    assert any(isinstance(o, tuple) and o[1].shape == (*LAT, D_LAT) for o in done[1].items)
