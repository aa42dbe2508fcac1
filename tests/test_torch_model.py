"""PyTorch port: the model against the JAX package with the same weights
(carried by `weights.from_flax`): cached prefill logits and cache contents,
text decode steps, modality-row (ODE) steps, the int8 cache, and the
padded-prefill slot-gap regression. Float32 on the CPU, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.transformer import cache_mark_valid, make_kv_cache
from transfusion_tpu_torch.weights import from_flax

torch.set_num_threads(1)
CFG = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,), pad_multiple=16)


def tcfg(attn_impl):
    return dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl=attn_impl)


def jitter(params, seed=42, scale=0.05):
    """Break the zero-init symmetry so every branch carries signal."""
    key = jax.random.PRNGKey(seed)

    def f(path, p):
        nonlocal key
        key, k = jax.random.split(key)
        return p + jax.random.normal(k, p.shape) * scale

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX reference models, dense and flash, over one param tree
    (initialized through the dense model, which is cheaper on the CPU).
    The flash model prefills through the Pallas flash kernel; its cached
    decode takes the dense path (plain cache layout)."""
    dense = JaxTransfusion(transformer=tcfg("dense"), **CFG)
    params = jitter(dense.init_params(jax.random.PRNGKey(0)))
    return {"dense": dense, "flash": JaxTransfusion(transformer=tcfg("flash"), **CFG)}, params


@pytest.fixture(scope="module", params=["flash", "dense"])
def pair(request, jax_ref):
    models, params = jax_ref
    jm = models[request.param]
    tm = Transfusion(transformer=tcfg(request.param), device="cpu", **CFG)
    tm.load_flax(jax.tree.map(np.asarray, params))
    return jm, params, tm


def jax_prefill(jm):
    return jm._get_jit("sample_prefill", jm._prefill_impl,
                       static_argnames=("cap", "quantize", "transposed"))


def jax_decode(jm):
    return jm._get_jit("sample_decode_text", jm._decode_text_impl,
                       static_argnames=("temperature", "min_p"))


def items(m, with_modality=True):
    lat = np.random.default_rng(5).standard_normal((4, 16)).astype(np.float32)
    out = [np.asarray([m.sos_id, 1, 2, 3], np.int32)]
    if with_modality:
        out += [np.asarray([m.meta_id, m.char_offset + ord("4"), m.som_ids[0]], np.int32),
                (0, lat), np.asarray([m.eom_ids[0], 5], np.int32)]
    return out


def test_from_flax_maps_every_parameter(pair):
    jm, params, tm = pair
    sd = from_flax(jax.tree.map(np.asarray, params), tm)
    assert set(sd) == set(tm.core.state_dict())
    w = params["params"]["transformer"]["block_1"]["attn_1"]["to_qk"]["kernel"]
    np.testing.assert_array_equal(sd["transformer.blocks.1.attn.to_qk.weight"].numpy(),
                                  np.asarray(w).T)
    np.testing.assert_array_equal(sd["transformer.fourier_weights"].numpy(),
                                  np.asarray(params["params"]["transformer"]["fourier_weights"]))
    bad = jax.tree.map(np.asarray, params)
    bad["params"]["transformer"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        from_flax(bad, tm)


@pytest.mark.parametrize("rows", [1, 2])
def test_prefill_cache_and_decode_steps_match_jax(pair, rows):
    """Prefill logits and K/V cache contents, then 8 text decode steps
    (teacher-forced tokens) — logits at atol 1e-4."""
    jm, params, tm = pair
    batch = [items(jm)] * rows
    if rows == 2:  # the CFG layout: an uncond row with text nulled
        batch[1] = [np.where(it >= 0, jm.null_text_id, it) if not isinstance(it, tuple)
                    else it for it in batch[1]]
    packed = jm.pack(batch, wrap_sos_eos=False, add_meta=False)
    j_last, j_cache = jax_prefill(jm)(params, jax.tree.map(jnp.asarray, packed), cap=128,
                                       transposed=False)
    t_last, t_cache = tm._prefill_impl(tm.pack(batch, wrap_sos_eos=False, add_meta=False),
                                       cap=128)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), atol=1e-4)
    n = packed.text.shape[1]
    for kk in ("k", "v"):
        np.testing.assert_allclose(t_cache[kk][..., :n, :].numpy(),
                                   np.asarray(j_cache[kk])[..., :n, :], atol=1e-4)
    assert int(t_cache["idx"]) == int(j_cache["idx"]) == n
    np.testing.assert_array_equal(t_cache["mask"].numpy(), np.asarray(j_cache["mask"]))

    pos = int(packed.lengths[0]) - 3  # the modality collapses 4 slots into 1 position
    for step, tok in enumerate([3, 1, 7, 2, 0, 6, 5, 4]):
        toks = [[tok]] + [[jm.null_text_id]] * (rows - 1)
        _, j_logits, j_cache = jax_decode(jm)(
            params, j_cache, jnp.asarray(toks, jnp.int32),
            jnp.asarray([[pos + step]] * rows, jnp.int32), jax.random.PRNGKey(0),
            temperature=0.0, min_p=0.1)
        _, t_logits, t_cache = tm._decode_text_impl(
            t_cache, torch.tensor(toks), torch.tensor([[pos + step]] * rows), None,
            temperature=0.0, min_p=0.1)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4,
                                   err_msg=f"decode step {step}")


def test_modality_rows_step_matches_jax(pair):
    """One ODE evaluation over a modality's rows against the history."""
    jm, params, tm = pair
    batch = [items(jm, with_modality=False)]
    packed = jm.pack(batch, wrap_sos_eos=False, add_meta=False)
    _, j_cache = jax_prefill(jm)(params, jax.tree.map(jnp.asarray, packed), cap=128,
                                  transposed=False)
    _, t_cache = tm._prefill_impl(tm.pack(batch, wrap_sos_eos=False, add_meta=False), cap=128)
    y = np.random.default_rng(1).standard_normal((1, 4, 16)).astype(np.float32)
    rot = np.full((1, 4), 4)
    j_cache = jax.tree.map(lambda x: x, j_cache)
    from transfusion_tpu.models.transformer import cache_mark_valid as j_mark

    j_flow, _ = jm.core.apply(params, jnp.asarray(y), 0.25, jnp.asarray(rot),
                              j_mark(j_cache, jnp.ones((1, 4), bool)), 0,
                              method="decode_modality_rows")
    t_flow, _ = tm.core.decode_modality_rows(
        torch.tensor(y), torch.tensor(0.25), torch.tensor(rot),
        cache_mark_valid(t_cache, torch.ones((1, 4), dtype=torch.bool)), 0)
    np.testing.assert_allclose(t_flow.numpy(), np.asarray(j_flow), atol=1e-4)


def test_int8_cache_prefill_and_decode_match_jax(jax_ref):
    models, params = jax_ref
    jm = models["flash"]
    tm = Transfusion(transformer=tcfg("flash"), device="cpu", **CFG)
    tm.load_flax(jax.tree.map(np.asarray, params))
    batch = [items(jm, with_modality=False)]
    packed = jm.pack(batch, wrap_sos_eos=False, add_meta=False)
    j_last, j_cache = jax_prefill(jm)(params, jax.tree.map(jnp.asarray, packed), cap=128,
                                       quantize=True, transposed=False)
    t_last, t_cache = tm._prefill_impl(tm.pack(batch, wrap_sos_eos=False, add_meta=False),
                                       cap=128, quantize=True)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), atol=1e-4)
    assert t_cache["k"].dtype == torch.int8
    n = packed.text.shape[1]
    deq_t = t_cache["k"][..., :n, :].float() * t_cache["k_scale"][..., :n, None]
    deq_j = np.asarray(j_cache["k"])[..., :n, :] * np.asarray(j_cache["k_scale"]).swapaxes(-1, -2)[..., :n, :]
    np.testing.assert_allclose(deq_t.numpy(), deq_j, atol=2e-3)  # at most one int8 step apart
    for step, tok in enumerate([3, 1, 7]):
        _, j_logits, j_cache = jax_decode(jm)(
            params, j_cache, jnp.asarray([[tok]], jnp.int32), jnp.asarray([[4 + step]], jnp.int32),
            jax.random.PRNGKey(0), temperature=0.0, min_p=0.1)
        _, t_logits, t_cache = tm._decode_text_impl(
            t_cache, torch.tensor([[tok]]), torch.tensor([[4 + step]]), None,
            temperature=0.0, min_p=0.1)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-3)


def test_decode_kernel_padded_prefill_slot_gap(jax_ref):
    """After a padded prefill the write pointer sits at the padded width
    while the mask marks only the true prefix: the decode route must bound
    streaming by idx + n, not by the valid count, or the new token's K/V
    falls out of its own attention. Flash (decode route) == dense == JAX."""
    kw = dict(CFG, pad_multiple=64)
    jm = JaxTransfusion(transformer=tcfg("dense"), **kw)
    params = jax_ref[1]
    toks = np.r_[jm.sos_id, (np.arange(99) % 8)].astype(np.int32)
    packed = jm.pack([[toks]], wrap_sos_eos=False, add_meta=False)
    assert packed.text.shape[1] == 128
    j_last, j_cache = jax_prefill(jm)(params, jax.tree.map(jnp.asarray, packed), cap=384)
    _, j_logits, _ = jax_decode(jm)(
        params, j_cache, jnp.asarray([[5]], jnp.int32), jnp.asarray([[100]], jnp.int32),
        jax.random.PRNGKey(0), temperature=1.0, min_p=0.1)
    outs = {}
    for impl in ("flash", "dense"):
        tm = Transfusion(transformer=tcfg(impl), device="cpu", **kw)
        tm.load_flax(jax.tree.map(np.asarray, params))
        _, cache = tm._prefill_impl(tm.pack([[toks]], wrap_sos_eos=False, add_meta=False),
                                    cap=384)
        assert int(cache["idx"]) == 128
        _, outs[impl], _ = tm._decode_text_impl(cache, torch.tensor([[5]]),
                                                torch.tensor([[100]]), None,
                                                temperature=1.0, min_p=0.1)
    np.testing.assert_allclose(outs["flash"].numpy(), outs["dense"].numpy(), atol=1e-4)
    np.testing.assert_allclose(outs["flash"].numpy(), np.asarray(j_logits), atol=1e-4)


def test_cache_helpers():
    cache = make_kv_cache(2, 3, 2, 16, 8, track_mask=True, quantize="int8")
    assert cache["k"].shape == (2, 3, 2, 16, 8) and cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (2, 3, 2, 16)
    cache["idx"] = torch.tensor([0, 4, 9], dtype=torch.int32)
    marked = cache_mark_valid(cache, torch.ones((3, 2), dtype=torch.bool))
    assert marked["mask"].sum(1).tolist() == [2, 2, 2]
    assert marked["mask"][2, 9:11].all() and not cache["mask"].any()


def test_unported_paths_raise(jax_ref):
    """Context-parallel attention (which raised before the parallelism
    slice) builds and refuses a call without a mesh, and dropout with it,
    as JAX does (tests/test_torch_context_parallel.py holds it against
    JAX); a dropout model
    (which raised before the single-process surface slice) builds, and its
    training loss is refused as in JAX (tests/test_torch_dropout.py); the
    uncached flash `text_forward` (which raised before the training slice)
    now equals the JAX one, and so do `add_pos_emb` (which raised before the
    modality I/O slice: the joint forward's logits and flows, and the
    modality-only flow) and LASER and two residual streams (which raised
    before the recipe-options slice: the causal text forward)."""
    dm = Transfusion(transformer=dict(tcfg("flash"), dropout=0.1), device="cpu", **CFG)
    with pytest.raises(ValueError, match="dropout"):
        dm.loss([[np.asarray([1, 2, 3], np.int32)]], generator=torch.Generator())
    ring = Transfusion(transformer=tcfg("ring"), device="cpu", **CFG)
    with pytest.raises(ValueError, match="needs a mesh"):
        ring.core.text_forward(torch.zeros((1, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="dropout"):
        Transfusion(transformer=dict(tcfg("ring"), dropout=0.1), device="cpu", **CFG)
    toks = np.asarray([[8, 1, 2, 3, 7, 5], [8, 4, 4, 0, 1, 2]], np.int32)
    for opt in (dict(attn_laser=True), dict(num_residual_streams=2)):
        jm = JaxTransfusion(transformer=dict(tcfg("flash"), **opt), **CFG)
        p_opt = jitter(jm.init_params(jax.random.PRNGKey(4)))
        tm = Transfusion(transformer=dict(tcfg("flash"), **opt), device="cpu", **CFG)
        tm.load_flax(jax.tree.map(np.asarray, p_opt))
        j_logits = jm.core.apply(p_opt, jnp.asarray(toks), method="text_forward")[0]
        t_logits, _ = tm.core.text_forward(torch.tensor(toks, dtype=torch.int64))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4,
                                   err_msg=str(opt))
    jm = JaxTransfusion(transformer=tcfg("dense"), add_pos_emb=True, **CFG)
    p_pos = jitter(jm.init_params(jax.random.PRNGKey(3)))
    tm = Transfusion(transformer=tcfg("flash"), add_pos_emb=True, device="cpu", **CFG)
    tm.load_flax(jax.tree.map(np.asarray, p_pos))
    assert "pos_emb_mlps.0.layers.0.weight" in tm.core.state_dict()
    lat = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    batch = [[np.asarray([tm.sos_id, 1, 2], np.int32), (0, lat), np.asarray([3], np.int32)]]
    packed = jm.pack(batch)
    times = np.full((1, packed.spans.shape[1]), 0.3, np.float32)
    logits_j, _, flows_j, _, _ = jm.core.apply(p_pos, jax.tree.map(jnp.asarray, packed),
                                               jnp.asarray(times), method="joint")
    logits_t, _, flows_t, _, _ = tm.core.joint(tm.pack(batch).to_torch("cpu"),
                                               torch.tensor(times))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4)
    np.testing.assert_allclose(flows_t[0].numpy(), np.asarray(flows_j[0]), atol=1e-4)
    flow_j = jm.forward_modality(p_pos, lat[None], times=np.asarray([0.3]), return_loss=False)
    flow_t = tm.forward_modality(lat[None], times=np.asarray([0.3]), return_loss=False)
    np.testing.assert_allclose(flow_t.numpy(), np.asarray(flow_j), atol=1e-4)
    models, params = jax_ref
    tm = Transfusion(transformer=tcfg("flash"), device="cpu", **CFG)
    tm.load_flax(jax.tree.map(np.asarray, params))
    toks = np.asarray([[8, 1, 2, 3, 7, 5], [8, 4, 4, 0, 1, 2]], np.int32)
    j_logits = models["flash"].core.apply(params, jnp.asarray(toks), method="text_forward")[0]
    t_logits, _ = tm.core.text_forward(torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)


def test_uncached_flash_outside_kernel_shapes_matches_jax():
    """Head dim 16 is outside `supported`: the uncached flash route takes
    the dense path with the causal|span mask built from the flash spec,
    as `transfusion_flash_attention` falls back to `_reference_attention`."""
    cfg = dict(dim=32, depth=2, dim_head=16, heads=2, attn_impl="flash")
    jm = JaxTransfusion(transformer=cfg, **CFG)
    params = jitter(jm.init_params(jax.random.PRNGKey(1)))
    tm = Transfusion(transformer=cfg, device="cpu", **CFG)
    tm.load_flax(jax.tree.map(np.asarray, params))
    toks = np.asarray([[8, 1, 2, 3, 7, 5, 6, 0]], np.int32)
    j_logits = jm.core.apply(params, jnp.asarray(toks), method="text_forward")[0]
    t_logits, _ = tm.core.text_forward(torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)
