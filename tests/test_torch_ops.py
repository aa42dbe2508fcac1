"""PyTorch port: leaf ops, packing and helpers against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is float32 on the CPU."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.data import packing as jpack
from transfusion_tpu.models import layers as jlayers
from transfusion_tpu.ops import flow as jflow
from transfusion_tpu.ops import norms as jnorms
from transfusion_tpu.ops import rope as jrope
from transfusion_tpu.ops import spans as jspans
from transfusion_tpu.utils import helpers as jhelp
from transfusion_tpu_torch.data import packing as tpack
from transfusion_tpu_torch.models import layers as tlayers
from transfusion_tpu_torch.models.serving import plan_serving
from transfusion_tpu_torch.models.transformer import Transformer, make_kv_cache
from transfusion_tpu_torch.ops import flow as tflow
from transfusion_tpu_torch.ops import hyper_connections as thc
from transfusion_tpu_torch.ops import norms as tnorms
from transfusion_tpu_torch.ops import odeint as tode
from transfusion_tpu_torch.ops import rope as trope
from transfusion_tpu_torch.ops import spans as tspans
from transfusion_tpu_torch.utils import helpers as thelp

# the package re-exports the function under the module's name
jode = importlib.import_module("transfusion_tpu.ops.odeint")

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
X = RNG.standard_normal((3, 5, 16)).astype(np.float32) * 30
SPANS = np.asarray(
    [[[0, 2, 5], [0, 9, 3], [0, 0, 0]], [[0, 1, 0], [0, 4, 8], [0, 13, 2]]], np.int32
)


def close(t, j, atol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("name", ["l2norm", "softclamp", "safe_log"])
def test_norms(name):
    x = np.abs(X) if name == "safe_log" else X
    close(getattr(tnorms, name)(torch.tensor(x)), getattr(jnorms, name)(jnp.asarray(x)))


def test_max_neg_value():
    assert tnorms.max_neg_value() == float(jnorms.max_neg_value())


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope(pos_shape):
    pos = RNG.integers(0, 300, size=pos_shape)
    ang_t = trope.rope_angles(torch.tensor(pos), 16)
    ang_j = jrope.rope_angles(jnp.asarray(pos), 16)
    close(ang_t, ang_j, atol=1e-3)  # angles up to 300 rad: float32 ulp ~3e-5
    t = RNG.standard_normal((2, 3, 7, 16)).astype(np.float32)
    a_t = ang_t if len(pos_shape) == 1 else ang_t[:, None]
    a_j = ang_j if len(pos_shape) == 1 else ang_j[:, None]
    close(trope.apply_rope(a_t, torch.tensor(t)), jrope.apply_rope(a_j, jnp.asarray(t)), 1e-4)


@pytest.mark.parametrize(
    "name", ["spans_to_instance_mask", "spans_to_is_any_modality",
             "spans_to_attn_mask", "spans_to_rotary_positions"],
)
def test_spans(name):
    out_t = getattr(tspans, name)(16, torch.tensor(SPANS, dtype=torch.int64))
    out_j = getattr(jspans, name)(16, jnp.asarray(SPANS))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_span_allowed_offsets_match_full_mask():
    """span_allowed at offsets is the matching window of the full mask."""
    full = tspans.spans_to_attn_mask(16, torch.tensor(SPANS, dtype=torch.int64))
    part = tspans.span_allowed(torch.arange(8) + 8, torch.arange(4) + 2,
                               torch.tensor(SPANS, dtype=torch.int64))
    assert torch.equal(part, full[:, 8:16, 2:6])


@pytest.mark.parametrize("min_p", [0.0, 0.1, 0.5])
def test_min_p_filter(min_p):
    lg = X[0]
    out_t = tflow.min_p_filter(torch.tensor(lg), min_p).numpy()
    out_j = np.asarray(jflow.min_p_filter(jnp.asarray(lg), min_p))
    np.testing.assert_array_equal(np.isinf(out_t), np.isinf(out_j))
    close(np.where(np.isinf(out_t), 0, out_t), np.where(np.isinf(out_j), 0, out_j))


def test_model_output_to_flow():
    out, noised = X[:, :4], X[:, 1:5]
    t = np.asarray([0.0, 0.5, 0.999], np.float32)
    close(tflow.model_output_to_flow(torch.tensor(out), torch.tensor(noised), torch.tensor(t), 1e-2),
          jflow.model_output_to_flow(jnp.asarray(out), jnp.asarray(noised), jnp.asarray(t), 1e-2),
          atol=1e-3)


def test_gumbel_sample_greedy_and_seeded():
    lg = torch.tensor(X[0])
    assert torch.equal(tflow.gumbel_sample(lg, 0.0), lg.argmax(-1))
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    assert torch.equal(tflow.gumbel_sample(lg, 1.0, g1), tflow.gumbel_sample(lg, 1.0, g2))


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_odeint_fixed_grid(method):
    y0 = RNG.standard_normal((4, 3)).astype(np.float32)
    a = RNG.standard_normal((3, 3)).astype(np.float32) * 0.5
    out_t = tode.odeint(lambda t, y: y @ torch.tensor(a) + t, torch.tensor(y0),
                        torch.linspace(0, 1, 9), method=method)
    out_j = jode.odeint(lambda t, y: y @ jnp.asarray(a) + t, jnp.asarray(y0),
                        jnp.linspace(0, 1, 9), method=method)
    close(out_t, out_j)


def test_odeint_adaptive_not_ported():
    """The adaptive solver is ported now (tests/test_torch_odeint.py holds
    it against JAX); an unknown method still raises, naming the methods."""
    out_t = tode.odeint(lambda t, y: -y, torch.ones(2), torch.linspace(0, 1, 3),
                        method="adaptive")
    out_j = jode.odeint(lambda t, y: -y, jnp.ones(2), jnp.linspace(0, 1, 3), method="adaptive")
    close(out_t, out_j)
    with pytest.raises(ValueError, match="adaptive"):
        tode.odeint(lambda t, y: y, torch.zeros(2), torch.linspace(0, 1, 3), method="dopri5")


def test_single_stream_is_plain_residual():
    x = torch.tensor(X)
    s = thc.expand_stream(x)
    branch, mixed = thc.HyperConnection(16)(s)
    assert torch.equal(branch, x)
    assert torch.equal(thc.reduce_stream(thc.HyperConnection(16)(mixed, x)), 2 * x)
    # more streams are ported (tests/test_torch_laser_streams.py holds them
    # against JAX): the JAX module's parameters, fracs splitting the channels
    shapes = {k: tuple(p.shape) for k, p in thc.HyperConnection(16, streams=2, fracs=4)
              .named_parameters()}
    assert shapes == {"alpha_logit": (4, 2), "beta": (4, 2), "mix_logit": (4, 2, 2),
                      "alpha_dyn_kernel": (4, 4), "alpha_dyn_scale": (4,)}


def test_quantize_rows():
    x = np.concatenate([X, np.zeros((1, 5, 16), np.float32)])
    q_t, s_t = tlayers._quantize_rows(torch.tensor(x))
    q_j, s_j = jlayers._quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    close(s_t, s_j, atol=1e-7)


def test_random_fourier_embed():
    w = RNG.standard_normal(8).astype(np.float32)
    t = RNG.uniform(size=(2, 5)).astype(np.float32)
    close(tlayers.random_fourier_embed(torch.tensor(t), 16, torch.tensor(w)),
          jlayers.random_fourier_embed(jnp.asarray(t), 16, weights=jnp.asarray(w)), 1e-4)


def test_helpers():
    seq = np.asarray([5, 9, 1, 9, 3, 4], np.int32)
    np.testing.assert_array_equal(thelp.tokens_since_rightmost_id(seq, 9),
                                  jhelp.tokens_since_rightmost_id(seq, 9))
    assert thelp.decode_chars([60, 61], offset=10) == jhelp.decode_chars([60, 61], offset=10)
    items = [np.asarray([1, 2]), np.asarray([3]), (0, X[0]), np.asarray([4])]
    for a, b in zip(thelp.concat_contiguous_text(items), jhelp.concat_contiguous_text(items)):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)
    assert thelp.round_up_to_multiple(130, 128) == 256
    assert thelp.resolve_device("cpu") == torch.device("cpu")


def _spec(mod):
    ms = mod.ModalityPackSpec(dim_latent=4, som_id=11, eom_id=12)
    return mod.PackSpec(num_text_tokens=8, sos_id=8, eos_id=9, null_text_id=10,
                        meta_id=13, char_offset=14, modalities=(ms,))


@pytest.mark.parametrize("wrap,meta", [(True, True), (False, False)])
def test_pack_samples_matches_jax(wrap, meta):
    samples = [
        [np.asarray([1, 2, 3]), RNG.standard_normal((2, 3, 4)).astype(np.float32),
         np.asarray([4])],
        [np.asarray([5]), (0, RNG.standard_normal((2, 3, 4)).astype(np.float32)),
         (0, RNG.standard_normal((5, 4)).astype(np.float32))],
    ]
    kw = dict(wrap_sos_eos=wrap, add_meta=meta, pad_multiple=16)
    pt = tpack.pack_samples(samples, _spec(tpack), **kw)
    pj = jpack.pack_samples(samples, _spec(jpack), use_native=False, **kw)
    for f in ("text", "cfg_mask", "spans", "lengths"):
        np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)), err_msg=f)
    assert len(pt.groups) == len(pj.groups)
    for gt, gj in zip(pt.groups, pj.groups):
        assert (gt.modality_type, gt.latent_shape, gt.seq_shape) == (
            gj.modality_type, gj.latent_shape, gj.seq_shape)
        for f in ("latents", "batch_idx", "offsets", "span_rows"):
            np.testing.assert_array_equal(getattr(gt, f), np.asarray(getattr(gj, f)))


def test_layout_helpers():
    x = RNG.standard_normal((4, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpack.to_channel_last(x, True), jpack.to_channel_last(x, True))
    np.testing.assert_array_equal(tpack.to_user_layout(x, True), jpack.to_user_layout(x, True))
    sample = [np.int32(3), X[0], (0, X[1])]
    for a, b in zip(tpack.normalize_sample(sample), jpack.normalize_sample(sample)):
        if isinstance(a, tuple):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)


def test_plan_serving_routes_every_eligible_step_to_the_kernel():
    """The plan decides only the KV dtype; every eligible cached step of a
    flash model goes to the decode kernel, whatever the capacity."""
    assert not plan_serving(256, 1).kv_quantize
    assert plan_serving(256, 1, kv_quantize=True).kv_quantize
    assert not plan_serving(65536, 64).kv_quantize
    cache = make_kv_cache(2, 1, 2, 8192, 32, device="cpu")
    flash = Transformer(64, 2, dim_head=32, heads=2, attn_impl="flash")
    dense = Transformer(64, 2, dim_head=32, heads=2, attn_impl="dense")
    assert flash._use_decode_kernel(cache, False, None, True, 1)
    assert flash._use_decode_kernel(cache, False, None, False, 196)
    assert not flash._use_decode_kernel(cache, True, None, True, 1)
    assert not flash._use_decode_kernel(cache, False, None, True, 4)
    assert not dense._use_decode_kernel(cache, False, None, True, 1)
