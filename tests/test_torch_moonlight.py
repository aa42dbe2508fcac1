"""PyTorch port: the Moonlight (DeepSeek-V3) block, `MoonlightTransformer`
(a transformer config's "block": "moonlight"), against the benchmark's
plain float32 reference (`portbench/reference/moonlight.py`) at a tiny
size on the CPU: d 64, one dense and two expert layers, 16 routed experts
of which 8 are held, top 4, q k 24 + 8 RoPE dims beside values of 16, on
seeded random weights.

The joint loss and every gradient; latent attention with spans through the
plain flash route at unequal widths; routing by score + bias with weights
from the score; the selection bias through a Trainer step and a checkpoint;
the routing of a block rematerialized in the backward; and the expert
layer's shares: the routed parts of every share, with the shared experts
once, add up to the uncut layer; the state dict's names and shapes are the
ones the benchmark's spec loads; and what the stack does not run (a cache,
pipeline stages, a configuration lacking a key) is refused."""

import copy

import numpy as np
import pytest
import torch

from portbench import common, weights
from portbench.generators.train_packed import Rows, row_layout, step_rows
from portbench.reference import moonlight as reference
from portbench.reference.packing import pack
from portbench.runners.train import Draws, program_draws
from portbench.tests import tiny_moonlight
from transfusion_tpu_torch.models.moonlight import MLAttention, MoE
from transfusion_tpu_torch.ops.flash_attn import (backward_plain_f32, flash_attention,
                                                  flash_attention_plain)
from transfusion_tpu_torch.parallel.pipeline import LocalStages
from transfusion_tpu_torch.training import Trainer

CFG = tiny_moonlight.CFG
ARCH = common.architecture(CFG)
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    reference.strict_fp32()
    yield
    torch.set_num_threads(n)


def build(remat=False, seed=SEED):
    """The tiny model on the seed's weights, and the weights."""
    model = ARCH.build_model(CFG, {"model": {"remat": remat}}, "cpu")
    W = weights.make(ARCH, CFG, seed, "cpu")
    ARCH.load_weights(model, W)
    return model, W


def batch(model, seed=SEED):
    """One packed training batch of the tiny cell's traffic (text and
    caption-image rows) with the program's and the reference's draws."""
    traffic = tiny_moonlight.train_cell()["traffic"]
    rows = Rows(traffic, seed, CFG["num_text_tokens"], CFG["dim_latent"])
    idx = step_rows(traffic, 0)
    samples = [rows[i] for i in idx]
    n = traffic["row_len"] + 1
    packed = model.pack(samples, pad_len=n, shift_friendly=True).to_torch("cpu")
    draws = Draws(seed, "cpu", (*traffic["image_shape"], CFG["dim_latent"])).make(
        [row_layout(traffic, seed, i) for i in idx])
    ref_batch = pack(samples, n, CFG["num_text_tokens"], "cpu")
    return packed, program_draws(packed, draws), ref_batch, draws


def program_loss(model, params, packed, draws):
    leaves = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
    loss, _ = model._loss_impl(leaves, packed, draws, model.prob_uncond, train=True)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), dict(zip(leaves, grads))


def test_joint_loss_and_every_gradient_match_the_reference():
    model, W = build()
    packed, pd, ref_batch, draws = batch(model)
    assert packed.spans[..., 2].gt(0).any()  # the batch holds images
    names = [k for k, _ in model.core.named_parameters()]
    loss, grads = program_loss(model, {k: W[k] for k in names}, packed, pd)
    params = {k: W[k].clone().requires_grad_(True) for k in names}
    Wr = dict(W, **params)
    want, _, _ = reference.joint_loss(Wr, CFG, ref_batch, draws)
    want_g = torch.autograd.grad(want, list(params.values()), allow_unused=True)
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=1e-6)
    for k, g in zip(params, want_g):
        g = torch.zeros_like(params[k]) if g is None else g
        got = torch.zeros_like(g) if grads[k] is None else grads[k]
        scale = max(float(g.abs().max()), 1e-6)
        assert float((got - g).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("causal_only", [False, True])
def test_latent_attention_with_spans_matches_the_reference(causal_only):
    """MLA through the plain flash route (q k 32 beside v 16), forward and
    every gradient, against the reference's latent attention."""
    torch.manual_seed(0)
    attn = MLAttention(64, 2, 32, 24, 8, 16, "flash", 1e-5)
    x = torch.randn(2, 40, 64, requires_grad=True)
    spans = None if causal_only else torch.tensor([[[0, 5, 12], [0, 25, 8]],
                                                   [[0, 10, 20], [0, 0, 0]]])
    pos = torch.arange(40)[None].expand(2, 40)
    if spans is not None:
        from portbench.reference.model import rotary_positions

        pos = rotary_positions(40, spans)
    from transfusion_tpu_torch.ops.rope import rope_angles

    rope = rope_angles(pos, 8, 50000.0)
    out = attn(x, rope, {"spans": spans, "causal": True})
    W = {"a." + k: v for k, v in attn.named_parameters()}
    cfg = dict(CFG, num_attention_heads=2)
    want = reference.mla(W, "a.", cfg, x, pos, spans, None)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    g = torch.randn_like(out)
    got_g = torch.autograd.grad(out, [x, *attn.parameters()], g)
    want_g = torch.autograd.grad(want, [x, *attn.parameters()], g)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_flash_plain_versions_take_a_value_width_of_their_own():
    """The plain forward and backward at q k 24 beside v 16 against
    autograd through a dense softmax attention with the spans' mask."""
    g = torch.Generator().manual_seed(1)
    q, k = (torch.randn(1, 2, 30, 24, generator=g) for _ in range(2))
    v, do = (torch.randn(1, 2, 30, 16, generator=g) for _ in range(2))
    spans = torch.tensor([[[0, 4, 9]]])
    out, lse = flash_attention_plain(q, k, v, spans, 0.0)
    assert out.shape == (1, 2, 30, 16)
    from transfusion_tpu_torch.ops.spans import span_allowed

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    allowed = span_allowed(torch.arange(30), torch.arange(30), spans)[:, None]
    s = (leaves[0] @ leaves[1].transpose(-1, -2)) * 24**-0.5
    want = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1) @ leaves[2]
    torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=1e-5)
    delta = (do * out).sum(-1)
    got = backward_plain_f32(q, k, v, do, lse, delta, spans, 0.0)
    want_g = torch.autograd.grad(want, leaves, do)
    for a, b in zip(got, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # the autograd function routes through the same versions on the CPU
    qs = q.clone().requires_grad_(True)
    o = flash_attention(qs, k, v, spans=spans, softcap=0.0)
    o.backward(do)
    torch.testing.assert_close(qs.grad, want_g[0], rtol=1e-4, atol=1e-5)


def layer(held=8, experts=16, seed=0):
    torch.manual_seed(seed)
    return MoE(64, experts=experts, held=held, top_k=4, inner=32, shared=2, scale=2.446)


def moe_weights(moe):
    return {"m." + k: v for k, v in moe.state_dict().items() if k != "expert_load"}


def test_routing_follows_score_plus_bias_and_weights_the_score():
    """With a bias far above the scores' spread the choices are the bias's
    top k; the weights are the chosen scores (the bias left out), summing to
    routed_scaling_factor; the reference chooses alike."""
    moe = layer()
    bias = torch.zeros(16)
    bias[[3, 7, 11, 14]] = torch.tensor([10.0, 9.0, 8.0, 7.0])
    moe.gate.e_score_correction_bias.copy_(bias)
    x = torch.randn(50, 64)
    choice, w = moe.gate(x)
    assert (choice == torch.tensor([3, 7, 11, 14])).all()
    s = torch.sigmoid(x @ moe.gate.weight.T)
    want = s[:, [3, 7, 11, 14]]
    torch.testing.assert_close(w, want / want.sum(-1, keepdim=True) * 2.446)
    ref_choice, ref_w = reference.router(moe_weights(moe), "m.", dict(CFG), x)
    assert torch.equal(ref_choice, choice)
    torch.testing.assert_close(ref_w, w)


def test_expert_layer_share_matches_the_reference_and_counts_its_assignments():
    moe = layer()
    moe.gate.e_score_correction_bias.normal_(std=0.05)
    x = torch.randn(2, 30, 64)
    out = moe(x)
    want = reference.moe(moe_weights(moe), "m.", dict(CFG), x)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    choice, _ = moe.gate(x.reshape(60, 64))
    assert moe.expert_load.tolist() == torch.bincount(choice[choice < 8], minlength=8).tolist()


@pytest.mark.parametrize("held", [8, 2])
def test_expert_shares_add_up_to_the_uncut_layer(held):
    """Every share of `held` experts computes its routed part (the others'
    left out); the parts of all 16 / held shares, with the shared experts
    counted once, equal the uncut layer that holds all 16."""
    whole = layer(held=16)
    whole.gate.e_score_correction_bias.normal_(std=0.05)
    W = moe_weights(whole)
    cfg = dict(CFG, n_routed_experts=16)
    x = torch.randn(2, 30, 64)
    uncut = reference.moe(W, "m.", cfg, x)
    shared = reference.swiglu(W, "m.shared_experts.", x, None)
    total = shared.clone()
    for r in range(16 // held):
        ids = range(r * held, (r + 1) * held)
        share = dict(W)
        for k in ("m.experts.gate_up_proj", "m.experts.down_proj"):
            share[k] = W[k][r * held:(r + 1) * held]
        total += reference.moe(share, "m.", dict(CFG, n_routed_experts=held), x,
                               held=ids) - shared
    torch.testing.assert_close(total, uncut, rtol=1e-5, atol=1e-6)
    # the program's layer is share 0
    prog = layer(held=held)
    state = {k: v for k, v in whole.state_dict().items() if k != "expert_load"}
    for k in ("experts.gate_up_proj", "experts.down_proj"):
        state[k] = state[k][:held]
    prog.load_state_dict(state, strict=False)
    share0 = reference.moe(dict(W, **{k: W[k][:held] for k in (
        "m.experts.gate_up_proj", "m.experts.down_proj")}), "m.",
        dict(CFG, n_routed_experts=held), x, held=range(held))
    torch.testing.assert_close(prog(x), share0, rtol=1e-5, atol=1e-6)


def test_trainer_keeps_the_selection_bias_and_checkpoints_it(tmp_path):
    model, W = build()
    packed, pd, _, _ = batch(model)
    bias = {n: b.clone() for n, b in model.core.named_buffers()
            if n.endswith("e_score_correction_bias")}
    assert len(bias) == 2 and all(b.abs().sum() > 0 for b in bias.values())
    trainer = Trainer(model, checkpoint_dir=str(tmp_path))
    names = [k for k, _ in model.core.named_parameters()]
    assert not any(n in names for n in bias)
    state = trainer.init_state()
    state, _ = trainer.train_step(state, packed, draws=pd)
    buffers = dict(model.core.named_buffers())
    for n, b in bias.items():
        assert torch.equal(buffers[n], b) and n not in state.params
    trainer.save(state)
    with torch.no_grad():
        for n in bias:
            buffers[n].zero_()
    restored = trainer.restore()
    assert restored.step == 1
    for n, b in bias.items():
        assert torch.equal(buffers[n], b)


def test_recomputed_blocks_route_as_their_forward():
    """Under remat each expert layer's router runs twice a step (the forward,
    then its recompute in the backward, last layer first) and chooses the
    same experts both times; the counters count the forward once; the loss
    and gradients equal the model's without remat."""
    outs = {}
    for remat in (False, True):
        model, W = build(remat=remat)
        packed, pd, _, _ = batch(model)
        seen = []
        for b in model.core.transformer.blocks[1:]:
            b.mlp.gate.register_forward_hook(lambda m, a, o: seen.append(o[0].clone()))
        names = [k for k, _ in model.core.named_parameters()]
        outs[remat] = program_loss(model, {k: W[k] for k in names}, packed, pd)
        loads = [b.mlp.expert_load.clone() for b in model.core.transformer.blocks[1:]]
        outs[remat] += (seen, loads)
    seen = outs[True][2]
    assert len(seen) == 4 and len(outs[False][2]) == 2
    assert torch.equal(seen[0], seen[3]) and torch.equal(seen[1], seen[2])
    assert torch.equal(seen[0], outs[False][2][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[True][3], outs[False][3]))
    torch.testing.assert_close(outs[True][0], outs[False][0])
    for k, g in outs[False][1].items():
        if g is not None:
            torch.testing.assert_close(outs[True][1][k], g, rtol=1e-5, atol=1e-7)


def test_moonlight_stack_refuses_what_it_does_not_run():
    model, _ = build()
    with pytest.raises(NotImplementedError, match="latent KV cache"):
        model.core.text_forward(torch.zeros((1, 4), dtype=torch.int64),
                                cache=model._cache(1, 128, False, False), prefill=True)
    packed, pd, _, _ = batch(model)
    with pytest.raises(NotImplementedError, match="pipeline stages"):
        model._loss_impl(None, packed, pd, model.prob_uncond, pipeline=(LocalStages(1), 1))
    bad = copy.deepcopy(tiny_moonlight.CFG)
    del bad["kv_lora_rank"]
    with pytest.raises(ValueError, match="lacks"):
        ARCH.build_model(bad, {}, "cpu")
    assert np.isfinite(float(model.core.text_forward(torch.zeros((1, 4), dtype=torch.int64))[0]
                             .abs().sum()))


def test_state_dict_holds_the_names_and_shapes_the_benchmark_loads():
    """Every parameter and buffer the model saves is one the architecture's
    spec lists (what `weights.make` draws and `load_weights` copies in),
    with its shape, and the spec lists nothing the model lacks."""
    model = ARCH.build_model(CFG, {}, "cpu")
    got = {k: tuple(t.shape) for k, t in model.core.state_dict().items()}
    assert got == {name: tuple(shape) for name, shape, _ in ARCH.spec(CFG)}


def test_donated_update_matches_the_functional_update():
    """`Trainer(donate_state=True)` writes the new state over the old one
    (what lets the 2.8B share's masters, moments and EMA fit one card) and
    gives the same bits as the update that leaves the old state as it was,
    step after step."""
    states = {}
    for donate in (False, True):
        model, W = build()
        packed, pd, _, _ = batch(model)
        trainer = Trainer(model, donate_state=donate, ema_update_after_step=1,
                          ema_update_every=1)
        state = trainer.init_state()
        for _ in range(3):
            before = {k: (p, p.clone()) for k, p in state.params.items()}
            state, metrics = trainer.train_step(state, packed, draws=pd)
            for k, p in state.params.items():
                assert (before[k][0] is p) == donate, k
                assert donate or torch.equal(before[k][0], before[k][1]), k
        states[donate] = state
    for k, p in states[False].params.items():
        assert torch.equal(p, states[True].params[k]), k
        assert torch.equal(states[False].ema.params[k], states[True].ema.params[k]), k
        assert torch.equal(states[False].opt_state[1]["nu"][k], states[True].opt_state[1]["nu"][k])
    with pytest.raises(ValueError, match="donate_state"):
        from transfusion_tpu_torch.training import optim

        Trainer(build()[0], optimizer=optim.adam(1e-3), donate_state=True)


def _out_of_place(grads, params, adam, ema, *, lr, clip, b1=0.9, b2=0.999, eps=1e-8,
                  a=0.99, b=0.01):
    """The update over all leaves at once, out of place, in the optax op
    order (the form the in-place pass replaced)."""
    keys = list(params)
    g, p, mu, nu, e = ([d[k] for k in keys] for d in (grads, params, adam["mu"], adam["nu"],
                                                      ema))
    from transfusion_tpu_torch.training.optim import _bias_correction, global_norm

    norm = global_norm(grads)
    trig = norm < clip
    g = torch._foreach_mul(torch._foreach_div(g, torch.where(trig, 1.0, norm)),
                           torch.where(trig, 1.0, torch.tensor(clip)))
    count = adam["count"] + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                            torch._foreach_mul(nu, b2))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), eps)
    upd = torch._foreach_mul(torch._foreach_div(torch._foreach_div(mu, c1), den), -lr)
    p = torch._foreach_add(p, upd)
    e = torch._foreach_add(torch._foreach_mul(e, a), torch._foreach_mul(p, b))
    return [dict(zip(keys, x)) for x in (p, mu, nu, e)]


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("chunk", [1 << 26, 300, 1])
def test_fused_update_in_chunks_gives_the_whole_pass_bits(monkeypatch, chunk, donate):
    """The update, cut into chunks of leaves (one chunk; several; a leaf
    each), gives the out-of-place pass over all leaves bit for bit, clipped
    and not; donated, it writes into the tensors it was given, else it
    leaves them as they were."""
    from transfusion_tpu_torch.training import fused_update

    monkeypatch.setattr(fused_update, "CHUNK_ELEMENTS", chunk)
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (7, 13), "b": (200,), "c": (3, 5, 11), "d": (1,), "e": (40, 9)}
    rnd = lambda: {k: torch.randn(s, generator=gen) for k, s in shapes.items()}  # noqa: E731
    for clip in (0.5, 1e6):
        grads, params, ema = rnd(), rnd(), rnd()
        adam = {"count": 4, "mu": rnd(), "nu": {k: v.abs() for k, v in rnd().items()}}
        want = _out_of_place(grads, params, adam, ema, lr=3e-4, clip=clip)
        given = [{k: (x, x.clone()) for k, x in d.items()}
                 for d in (params, adam["mu"], adam["nu"], ema)]
        p, new_adam, e, _ = fused_update.fused_clip_adam_ema(
            grads, params, adam, ema, 200, learning_rate=3e-4, grad_clip_norm=clip,
            ema_update_after_step=100, ema_update_every=1, donate=donate)
        assert new_adam["count"] == 5
        for got, w, old in zip((p, new_adam["mu"], new_adam["nu"], e), want, given):
            for k in shapes:
                assert torch.equal(got[k], w[k]), k
                assert (got[k] is old[k][0]) == donate, k
                assert donate or torch.equal(old[k][0], old[k][1]), k
