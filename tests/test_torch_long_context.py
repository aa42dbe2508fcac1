"""PyTorch port, long-context training against the JAX package on the CPU,
in float32: the streamed attention route (rows 3 and 9 of the kernel table,
forced at a small length by lowering the JAX envelopes, as
tests/test_pallas_attn.py does), the blocked plain versions of the
attention kernels, per-block remat ('full' and 'dots'), the sequence-chunked
cross-entropy, the loss denominators of exact gradient accumulation, and
`Trainer(grad_accumulation=2)` with all of them on.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions of its kernels (the CUDA kernels against those are in
test_torch_cuda.py). Inputs and draws are made with numpy / the JAX key
schedule and handed over as arrays. Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_attention import arrays, jax_grads, torch_grads
from test_torch_training import CFG, core_params, draws_from_key, init_params, np_tree, samples
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.ops import pallas_attn_kernel as jflash
from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.ops import flash_attn
from transfusion_tpu_torch.training import Trainer

torch.set_num_threads(1)

# the 573M config's structure at a tiny width: head-major flash attention
TCFG = dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="flash")
SPANS1 = np.asarray([[[0, 40, 100], [0, 150, 64]]], np.int32)


def assert_rel_close(got, want, rel, what):
    """Each array within rel of the reference's largest element."""
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, f"{what} [{i}]: {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# attention: the streamed route and the blocked plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["spans", "causal", "offsets", "lse"])
def test_streamed_route_matches_jax(monkeypatch, case):
    """b1 h2 n256 d64 through the JAX streamed forward (`_kernel_streamed`)
    and backward (`_flash_bwd_streamed`), forced by envelopes of 1, against
    the port's head-major route. Forward within 1e-5 (out) / 1e-4 (lse),
    dq/dk/dv within 1e-4 of each gradient's largest element."""
    monkeypatch.setattr(jflash, "_MAX_N_TIMES_D_RESIDENT", 1)
    monkeypatch.setattr(jflash, "_MAX_N_TIMES_D_BWD", 1)
    b, h, n, d = 1, 2, 256, 64
    q, k, v, go = arrays(*[(b, h, n, d)] * 4, seed=11)
    (gl,) = arrays((b, h, n), seed=12)
    kw = dict(causal=True)
    if case in ("spans", "lse"):
        kw["spans"] = SPANS1
    if case == "offsets":
        kw.update(spans=SPANS1, q_offset=64, kv_offset=32)
    if case == "lse":
        kw["return_lse"] = True
    cts = (go, gl) if case == "lse" else (go,)
    kw_t = {**kw, "spans": None if "spans" not in kw else torch.tensor(kw["spans"])}
    kw_j = {**kw, "spans": None if "spans" not in kw else jnp.asarray(kw["spans"])}
    out_t, g_t = torch_grads(lambda q, k, v: flash_attn.flash_attention(q, k, v, **kw_t),
                             (q, k, v), cts)
    out_j, g_j = jax_grads(lambda q, k, v: jflash.flash_attention(q, k, v, **kw_j),
                           (q, k, v), cts)
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-5, err_msg="out")
    if case == "lse":
        np.testing.assert_allclose(out_t[1], out_j[1], atol=1e-4, err_msg="lse")
    assert_rel_close(g_t, g_j, 1e-4, f"dq/dk/dv {case}")


def test_tpu_rows_follow_the_jax_routing():
    """`tpu_row` names the kernel the JAX routing picks (`_flash_fwd`
    :359-360, `_bwd` :1084-1100), from the JAX module's own predicates."""
    def jax_rows(h, n, d):
        streamed = n * d > jflash._MAX_N_TIMES_D_RESIDENT
        fwd = 3 if streamed else (1 if jflash._use_batched(h, n, n, d, bwd=False) else 2)
        if jflash._use_batched(h, n, n, d, bwd=True) and n * d <= jflash._MAX_N_TIMES_D_BWD:
            bwd = 7
        else:
            bwd = 9 if n * d > jflash._MAX_N_TIMES_D_BWD else 8
        return fwd, bwd

    seen = set()
    for h, n, d in [(8, 256, 64), (2, 128, 32), (8, 1024, 64), (2, 300, 64), (16, 4096, 64),
                    (16, 4160, 64), (8, 8192, 64), (16, 12288, 64), (16, 16384, 64),
                    (4, 8192, 128), (1, 512, 32)]:
        want = jax_rows(h, n, d)
        got = (flash_attn.tpu_row(h, n, n, d, bwd=False), flash_attn.tpu_row(h, n, n, d, bwd=True))
        assert got == want, (h, n, d)
        seen.update(got)
    assert seen == {1, 2, 3, 7, 8, 9}
    assert flash_attn.tpu_row(16, 16384, 16384, 64, bwd=False) == 3
    assert flash_attn.tpu_row(16, 16384, 16384, 64, bwd=True) == 9


def test_blocked_plain_versions_equal_unblocked():
    """The plain forward and backward computed 48 query rows at a time (a
    block that does not divide n; dk/dv summed over the blocks) equal the
    one-block versions to 1e-6, with spans and offsets."""
    b, h, n, d = 2, 2, 200, 32
    q, k, v, do = (torch.tensor(x) for x in arrays(*[(b, h, n, d)] * 4, seed=13))
    spans = torch.tensor([[[0, 20, 50], [0, 100, 30]], [[0, 5, 0], [0, 60, 120]]])
    args = (spans, 50.0, 24, 8)
    out, lse = flash_attn.flash_attention_plain(q, k, v, *args)
    out_b, lse_b = flash_attn.flash_attention_plain(q, k, v, *args, block_q=48)
    torch.testing.assert_close(out_b, out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse_b, lse, atol=1e-6, rtol=0)
    delta = (do * out).sum(-1)
    full = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, *args)
    blocked = flash_attn.flash_attention_backward_plain(q, k, v, do, lse, delta, *args,
                                                        block_q=48)
    for name, a, w in zip(("dq", "dk", "dv"), blocked, full):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=0, msg=name)


# ---------------------------------------------------------------------------
# the model: remat, chunked cross-entropy, loss denominators
# ---------------------------------------------------------------------------


def loss_and_grads(jm, tm, params, rng, packed_np):
    """The JAX and the port's joint loss and every parameter gradient on
    the same weights and draws. Returns ((total_j, grads_j), (total_t,
    grads_t)) with the grads as the port's parameter dicts."""
    def jloss(p):
        return jm._loss_impl(p, jax.tree.map(jnp.asarray, packed_np), rng, None, None,
                             prob_uncond=0.5, velocity_delta=1e-3, train=True)

    (total_j, _), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    leaves = {k: p.requires_grad_(True) for k, p in core_params(tm, params).items()}
    packed_t = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    total_t, _ = tm._loss_impl(leaves, packed_t, draws_from_key(rng, packed_np), 0.5)
    grads_t = torch.autograd.grad(total_t, list(leaves.values()), allow_unused=True)
    grads_t = {k: torch.zeros_like(p) if g is None else g
               for (k, p), g in zip(leaves.items(), grads_t)}
    return (float(total_j), core_params(tm, grads_j)), (total_t.item(), grads_t)


def assert_grads_match(got, want, atol, what):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_jax(policy, monkeypatch):
    """remat=True under each policy: the loss within 1e-5 relative and every
    gradient within 1e-4 of the JAX model's (`nn.remat` per block), and the
    attention forward runs twice per layer (once more in the backward's
    recomputation)."""
    tcfg = dict(TCFG, remat=True, remat_policy=policy)
    jm = JaxTransfusion(transformer=tcfg, **CFG)
    tm = Transfusion(transformer=tcfg, device="cpu", **CFG)
    params = init_params("head-major", seed=2)
    tm.load_flax(np_tree(params))
    calls = []
    forward = flash_attn._forward
    monkeypatch.setattr(flash_attn, "_forward", lambda *a: calls.append(1) or forward(*a))
    (total_j, grads_j), (total_t, grads_t) = loss_and_grads(
        jm, tm, params, jax.random.PRNGKey(21), jm.pack(samples(), shift_friendly=True))
    assert len(calls) == 2 * TCFG["depth"]
    np.testing.assert_allclose(total_t, total_j, rtol=1e-5)
    assert_grads_match(grads_t, grads_j, 1e-4, f"remat {policy}")


def test_chunked_ce_matches_jax_and_unchunked():
    """ce_chunk_size 20 (n = 48 after the shift: the last chunk is padded):
    loss within 1e-5 relative and gradients within 1e-4 of the JAX model
    with the same chunk, and within 1e-6 (loss) / 1e-6 (gradients) of the
    port without chunking."""
    jm = JaxTransfusion(transformer=TCFG, ce_chunk_size=20, **CFG)
    tm = Transfusion(transformer=TCFG, ce_chunk_size=20, device="cpu", **CFG)
    tm_full = Transfusion(transformer=TCFG, device="cpu", **CFG)
    params = init_params("head-major", seed=3)
    for m in (tm, tm_full):
        m.load_flax(np_tree(params))
    rng = jax.random.PRNGKey(22)
    packed = jm.pack(samples(), shift_friendly=True)
    assert (packed.text.shape[1] - 1) % 20 != 0
    (total_j, grads_j), (total_t, grads_t) = loss_and_grads(jm, tm, params, rng, packed)
    np.testing.assert_allclose(total_t, total_j, rtol=1e-5)
    assert_grads_match(grads_t, grads_j, 1e-4, "chunked CE vs JAX")
    _, (total_f, grads_f) = loss_and_grads(jm, tm_full, params, rng, packed)
    np.testing.assert_allclose(total_t, total_f, atol=1e-6)
    assert_grads_match(grads_t, grads_f, 1e-6, "chunked vs unchunked")


def test_loss_denominators_match_jax():
    """Each microbatch's denominators and their sum equal JAX's (CFG drop
    from the same key), and injecting a batch's own denominators changes
    nothing (tests/test_grad_accum.py:58)."""
    jm = JaxTransfusion(transformer=TCFG, **CFG)
    tm = Transfusion(transformer=TCFG, device="cpu", **CFG)
    batch = samples(4) + samples(5)
    subs = [batch[:3], batch[3:]]
    keys = jax.random.split(jax.random.PRNGKey(23), 2)
    dj, dt, dropped = [], [], False
    for sub, key in zip(subs, keys):
        packed = jm.pack(sub, shift_friendly=True)
        draws = draws_from_key(key, packed)
        dj.append(jm.loss_denominators(jax.tree.map(jnp.asarray, packed), key))
        dt.append(tm.loss_denominators(tm.pack(sub, shift_friendly=True).to_torch("cpu"), draws))
        dropped = bool((draws.cfg_uniform < CFG["prob_uncond"]).any()) or dropped
    assert dropped, "no sample's text was dropped"
    for want, got in [*zip(dj, dt), (jm.sum_loss_denominators(dj),
                                     tm.sum_loss_denominators(dt))]:
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), key)

    params = core_params(tm, init_params("head-major", seed=4))
    packed = tm.pack(batch, shift_friendly=True).to_torch("cpu")
    draws = tm.make_draws(packed, torch.Generator().manual_seed(0))
    own = tm.loss_denominators(packed, draws)
    plain, bd_plain = tm._loss_impl(params, packed, draws, 0.5)
    injected, bd_inj = tm._loss_impl(params, packed, draws, 0.5, loss_scales=own)
    assert plain.item() == injected.item() and bd_plain.text.item() == bd_inj.text.item()


# ---------------------------------------------------------------------------
# the trainer: exact gradient accumulation
# ---------------------------------------------------------------------------


def text_batch(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 16, 5 + i).astype(np.int32)] for i in range(n)]


def test_text_only_accumulation_equals_full_batch_update():
    """On text-only data with prob_uncond 0 the loss draws nothing, so two
    separately packed microbatches must give the whole batch's loss, grad
    norm and update (tests/test_grad_accum.py:93), within 1e-5."""
    tm = Transfusion(transformer=TCFG, device="cpu", **dict(CFG, prob_uncond=0.0))
    plain, accum = Trainer(tm, learning_rate=1e-3), Trainer(tm, learning_rate=1e-3,
                                                            grad_accumulation=2)
    s0, m0 = plain.train_step(plain.init_state(), text_batch(), generator=torch.Generator())
    s1, m1 = accum.train_step(accum.init_state(), text_batch(), generator=torch.Generator())
    for key in ("loss", "grad_norm", "text_loss"):
        np.testing.assert_allclose(float(m1[key]), float(m0[key]), atol=1e-5, err_msg=key)
    for k in s0.params:
        np.testing.assert_allclose(s1.params[k].numpy(), s0.params[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_accumulating_trainer_matches_jax():
    """The slice as a whole: two steps of Trainer(grad_accumulation=2) over
    a model with remat and chunked CE, on a ragged batch of five samples
    (split 3 + 2), against the JAX Trainer with the same options and keys.
    Metrics within 2e-4 (as test_torch_training.py), params within 1e-5."""
    tcfg = dict(TCFG, remat=True)
    jm = JaxTransfusion(transformer=tcfg, ce_chunk_size=16, **CFG)
    tm = Transfusion(transformer=tcfg, ce_chunk_size=16, device="cpu", **CFG)
    kw = dict(learning_rate=1e-3, ema_beta=0.9, ema_update_every=1, ema_update_after_step=1)
    jtr = JaxTrainer(jm, grad_accumulation=2, **kw)
    ttr = Trainer(tm, grad_accumulation=2, **kw)
    params = init_params("head-major", seed=5)
    state_j = JaxTrainState(params=params, opt_state=jtr.tx.init(params),
                            ema=j_init_ema(params), step=jnp.zeros((), jnp.int32))
    tm.load_flax(np_tree(params))
    state_t = ttr.init_state(core_params(tm, params))
    batch = samples(6) + samples(7)[:2]
    packs = [jm.pack(sub, shift_friendly=True) for sub in (batch[:3], batch[3:])]
    for i in range(2):
        rng = jax.random.PRNGKey(200 + i)
        state_j, met_j = jtr.train_step(state_j, batch, rng)
        draws = [draws_from_key(key, p) for key, p in zip(jax.random.split(rng, 2), packs)]
        state_t, met_t = ttr.train_step(state_t, batch, draws=draws)
        for key in ("loss", "text_loss", "flow_loss_0", "grad_norm"):
            np.testing.assert_allclose(float(met_t[key]), float(met_j[key]), atol=2e-4,
                                       err_msg=f"step {i} {key}")
    assert state_t.step == int(state_j.step) == 2
    want = core_params(tm, state_j.params)
    for k in want:
        np.testing.assert_allclose(state_t.params[k].numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_grad_accumulation_guards():
    tm = Transfusion(transformer=TCFG, device="cpu", **CFG)
    with pytest.raises(ValueError, match=">= 2"):
        Trainer(tm, grad_accumulation=1)
    tr = Trainer(tm, grad_accumulation=2)
    state = tr.init_state()
    packed = tm.pack(samples(), shift_friendly=True)
    with pytest.raises(ValueError, match="single packed batch"):
        tr.train_step(state, packed)
    with pytest.raises(ValueError, match="single packed batch"):
        tr.train_steps(state, packed, 2)
    with pytest.raises(ValueError, match="expected grad_accumulation=2"):
        tr.train_step(state, [packed])
    with pytest.raises(ValueError, match="cannot split"):
        tr.train_step(state, samples()[:1])
    state, metrics = tr.train_steps(state, [packed, packed], 2, generator=torch.Generator())
    assert state.step == 2 and np.isfinite(float(metrics["loss"]))
