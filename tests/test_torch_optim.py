"""PyTorch port: the optimizers and training utilities against the JAX
package and optax, float32 on the CPU: `adam`, `adam_atan2`, `muon`,
`muon_adam_atan2`, `chain` / `clip_by_global_norm` and `MultiSteps` on the
same gradients over 3 steps; `muon_param_mask` / `muon_parameters` against
the JAX mask; `Trainer(optimizer=muon_adam_atan2(...))` steps (also with
`grad_accumulation=2`) against the JAX `Trainer`; a checkpoint round trip
with the optimizer state; `ProfilerHook` and `metrics_path`; and
`create_ema` against the JAX `EMA`.

Tolerances: elementwise transformations 1e-5 relative. Muon's
Newton-Schulz runs in bf16 in both packages (the same iteration; their
bf16 products round apart), so on the full-rank random gradients here a
Muon update is held to 10 % of its Frobenius norm."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_training import (
    CFG,
    TCFG,
    core_params,
    draws_from_key,
    init_params,
    np_tree,
    samples,
)
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.training import optim as jax_optim
from transfusion_tpu.training.ema import EMA as JaxEMA
from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.training import Trainer, optim
from transfusion_tpu_torch.weights import from_flax

torch.set_num_threads(1)

# a flax-like tree and its port names: kernels [in, out], weights [out, in]
SHAPES = {("attn", "to_v", "kernel"): (12, 16), ("attn", "to_out", "kernel"): (16, 12),
          ("attn", "to_value_residual_mix", "kernel"): (12, 2),
          ("attn", "to_value_residual_mix", "bias"): (2,), ("ff", "proj_in", "kernel"): (12, 20),
          ("attn", "to_qk", "kernel"): (12, 32), ("norm", "gamma"): (12,)}


def port_name(path):
    return ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))


def tree_of(flat):
    out = {}
    for path, arr in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(arr)
    return out


def leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def to_port(arr, path):
    return torch.tensor(np.ascontiguousarray(arr.T if path[-1] == "kernel" else arr))


def grads_seq(seed=0, steps=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return [{path: (rng.standard_normal(s) * scale).astype(np.float32)
             for path, s in SHAPES.items()} for _ in range(steps)]


def run_both(tx_j, tx_t, steps, params_np):
    """The updates of both transformations over `steps` (a list of flat
    grad dicts), as lists of {path: numpy update in flax orientation}."""
    params_j = tree_of(params_np)
    params_t = {port_name(p): to_port(a, p) for p, a in params_np.items()}
    st_j, st_t = tx_j.init(params_j), tx_t.init(params_t)
    outs = []
    for g in steps:
        u_j, st_j = tx_j.update(tree_of(g), st_j, params_j)
        u_t, st_t = tx_t.update({port_name(p): to_port(a, p) for p, a in g.items()}, st_t,
                                params_t)
        params_j = optax.apply_updates(params_j, u_j)
        params_t = optim.apply_updates(params_t, u_t)
        outs.append({p: (leaf(u_j, p), u_t[port_name(p)].numpy()) for p in g})
    return outs


def check(outs, muon_paths=(), what=""):
    for i, step in enumerate(outs):
        for path, (want, got) in step.items():
            got = got.T if path[-1] == "kernel" else got
            if path in muon_paths:
                err = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert err <= 0.1, (what, i, path, err)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                           err_msg=f"{what} step {i} {path}")


def params0():
    return grads_seq(seed=9, steps=1, scale=0.1)[0]


def test_adam_clip_and_adam_atan2_match_optax():
    steps = grads_seq()
    check(run_both(optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3)),
                   optim.chain(optim.clip_by_global_norm(0.5), optim.adam(1e-3)),
                   steps, params0()), what="clip + adam")
    check(run_both(optax.adam(1e-3), optim.adam(1e-3), grads_seq(scale=1e-3), params0()),
          what="adam, below the clip")
    check(run_both(jax_optim.adam_atan2(1e-3, weight_decay=0.1),
                   optim.adam_atan2(1e-3, weight_decay=0.1), steps, params0()),
          what="adam_atan2")


def test_muon_matches_jax():
    """Muon on every leaf: Newton-Schulz on the matrices (the flax scale
    max(1, in / out) ** 0.5: 1 for to_v 12 -> 16, sqrt(6) for the mix
    12 -> 2), momentum alone on the vectors."""
    outs = run_both(jax_optim.muon(1e-3), optim.muon(1e-3), grads_seq(), params0())
    mats = [p for p, s in SHAPES.items() if len(s) == 2]
    check(outs, muon_paths=mats, what="muon")


def test_muon_adam_atan2_and_multisteps_match_jax():
    mask_j = jax_optim.muon_param_mask(tree_of(params0()))
    masked = [p for p in SHAPES if leaf(mask_j, p)]
    mask_t = optim.muon_param_mask({port_name(p): to_port(a, p) for p, a in params0().items()})
    assert sorted(k for k, m in mask_t.items() if m) == sorted(map(port_name, masked))
    assert mask_t["attn.to_value_residual_mix.weight"]
    outs = run_both(optax.chain(optax.clip_by_global_norm(0.5),
                                jax_optim.muon_adam_atan2(1e-3, 3e-4)),
                    optim.chain(optim.clip_by_global_norm(0.5), optim.muon_adam_atan2(1e-3, 3e-4)),
                    grads_seq(), params0())
    check(outs, muon_paths=masked, what="muon_adam_atan2")
    # MultiSteps(k=2) over 6 calls: zeros on calls 1, 3, 5; the inner adam on
    # the running mean on calls 2, 4, 6
    outs = run_both(optax.chain(optax.clip_by_global_norm(0.5),
                                optax.MultiSteps(optax.adam(1e-3), every_k_schedule=2)),
                    optim.chain(optim.clip_by_global_norm(0.5),
                                optim.MultiSteps(optim.adam(1e-3), every_k_schedule=2)),
                    grads_seq(steps=6), params0())
    check(outs, what="MultiSteps")
    assert all(not np.any(got) for _, got in outs[0].values())
    assert all(np.any(got) for _, got in outs[1].values())


def muon_mask_model(streams):
    cfg = dict(TCFG["token-major"], num_residual_streams=streams)
    jm = JaxTransfusion(transformer=dict(cfg, attn_impl="dense"), **CFG)
    params = jax.jit(lambda k: jm.core.init(k, method="init_all"))(jax.random.PRNGKey(0))
    return jm, params, Transfusion(transformer=cfg, device="cpu", **CFG)


@pytest.mark.parametrize("streams", [1, 4])
def test_muon_parameters_match_jax(streams):
    """The JAX mask (a tree of bools) carried through `from_flax` as
    constant arrays names the same parameters as `muon_parameters()`:
    V / out / feedforward in / out and, through the substring `to_v`, the
    value-residual mix; not the hyper-connections' `alpha_dyn_kernel`."""
    jm, params, tm = muon_mask_model(streams)
    mask = jm.muon_parameters(params)
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), mask, params)
    want = sorted(k for k, t in from_flax(as_arrays, tm).items()
                  if k in dict(tm.core.named_parameters()) and t.flatten()[0] == 1.0)
    assert sorted(tm.muon_parameters()) == want
    assert "transformer.blocks.1.attn.to_value_residual_mix.weight" in want
    assert "transformer.blocks.1.attn.to_qk.weight" not in want
    assert all("hc_" not in k for k in want)


def jax_state(jtr, params):
    return JaxTrainState(params=params, opt_state=jtr.tx.init(params),
                         ema=j_init_ema(params), step=jnp.zeros((), jnp.int32))


def hold_params(got, want_tree, before, tm, muon_names, muon_rel):
    """Against the JAX parameters: each Muon matrix within `muon_rel` of
    the JAX change (relative Frobenius norm). A gradient has many small
    singular values, and each Newton-Schulz iteration multiplies a small one
    by 3.4445, 490x over five: the bf16 roundings of the two packages part
    along those directions, though the grads agree to float32 rounding. The
    Adam-atan2 rest
    within 1e-5, except entries whose gradient is ~0 with a sign that
    rounding decides, which step by up to +-2 lr either way (atan2 is
    scale-free): at most 0.1 % of the entries, each within 4 lr a step."""
    want = core_params(tm, want_tree)
    flips = total = 0
    for k, w in want.items():
        diff = got[k] - w
        if k in muon_names:
            assert diff.norm().item() <= muon_rel * (w - before[k]).norm().item(), k
        else:
            flips += int((diff.abs() > 1e-5).sum())
            total += diff.numel()
            assert diff.abs().max().item() <= 4 * 3e-4 * 3, k
    assert flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize("accum", [None, 2], ids=["whole", "accum2"])
def test_muon_trainer_steps_match_jax(tmp_path, accum):
    """Three `Trainer(optimizer=muon_adam_atan2(...))` steps (clip 0.5,
    EMA from step 2 at beta 0.9) against the JAX Trainer. The first step's
    metrics within 2e-4 (as test_torch_training.py); the later steps'
    metrics within 1e-4 relative (their parameters carry the first updates'
    bf16 noise); the parameters after the first and the third step and the
    EMA as `hold_params` says. Then the checkpoint round trip with the
    optimizer state."""
    jm = JaxTransfusion(transformer=TCFG["token-major"], **CFG)
    tm = Transfusion(transformer=TCFG["token-major"], device="cpu", **CFG)
    kw = dict(ema_beta=0.9, ema_update_every=1, ema_update_after_step=1,
              grad_accumulation=accum)
    jtr = JaxTrainer(jm, optimizer=jax_optim.muon_adam_atan2(1e-3, 3e-4), **kw)
    ttr = Trainer(tm, optimizer=optim.muon_adam_atan2(1e-3, 3e-4),
                  checkpoint_dir=str(tmp_path), **kw)
    assert not jtr.fused_update and not ttr.fused_update
    params = init_params("token-major", seed=1)
    state_j = jax_state(jtr, params)
    tm.load_flax(np_tree(params))
    state_t = ttr.init_state(core_params(tm, params))
    before = {k: v.clone() for k, v in state_t.params.items()}
    muon_names = set(tm.muon_parameters())
    if accum:
        batch = samples(6) + samples(7)[:2]
        packs = [jm.pack(sub, shift_friendly=True) for sub in (batch[:3], batch[3:])]
    else:
        packed = jm.pack(samples(1), shift_friendly=True)
        batch_j = jax.tree.map(jnp.asarray, packed)
        batch = tm.pack(samples(1), shift_friendly=True).to_torch("cpu")
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        state_j, met_j = jtr.train_step(state_j, batch if accum else batch_j, rng)
        draws = ([draws_from_key(k, p) for k, p in zip(jax.random.split(rng, 2), packs)]
                 if accum else draws_from_key(rng, packed))
        state_t, met_t = ttr.train_step(state_t, batch, draws=draws)
        tol = dict(atol=2e-4) if i == 0 else dict(rtol=1e-4)
        for key in ("loss", "text_loss", "flow_loss_0"):
            np.testing.assert_allclose(float(met_t[key]), float(met_j[key]), **tol,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]),
                                   rtol=1e-4)
        if i == 0:
            hold_params(state_t.params, state_j.params, before, tm, muon_names, 0.5)
    assert state_t.step == int(state_j.step) == 3 and state_t.ema.step == 3
    hold_params(state_t.params, state_j.params, before, tm, muon_names, 0.5)
    hold_params(state_t.ema.params, state_j.ema.params, before, tm, muon_names, 0.5)

    ttr.save(state_t)
    restored = ttr.restore()
    assert restored.step == 3 and restored.opt_state[1]["adam"]["count"] == 3
    flat = lambda s: [t for t in jax.tree.leaves(s) if isinstance(t, torch.Tensor)]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(restored.opt_state),
                                                 flat(state_t.opt_state)))
    nxt = ([draws_from_key(k, p) for k, p in zip(jax.random.split(jax.random.PRNGKey(9), 2),
                                                  packs)]
           if accum else draws_from_key(jax.random.PRNGKey(9), packed))
    s1, m1 = ttr.train_step(state_t, batch, draws=nxt)
    s2, m2 = ttr.train_step(restored, batch, draws=nxt)
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)


def test_fused_update_choice_and_guard():
    tm = Transfusion(transformer=TCFG["head-major"], device="cpu", **CFG)
    assert Trainer(tm).fused_update
    assert not Trainer(tm, learning_rate=lambda count: 1e-3).fused_update
    assert not Trainer(tm, optimizer=optim.adam(1e-3)).fused_update
    with pytest.raises(ValueError, match="no optimizer"):
        Trainer(tm, optimizer=optim.adam(1e-3), fused_update=True)
    # the fused pass and the chain take the same step
    batch = samples(2)
    steps = [Trainer(tm, fused_update=f).train_step(
        Trainer(tm).init_state(), batch, generator=torch.Generator().manual_seed(0))[0]
        for f in (True, False)]
    for k, p in steps[0].params.items():
        np.testing.assert_allclose(p.numpy(), steps[1].params[k].numpy(), atol=1e-7, err_msg=k)
    # a chain as the optimizer: MultiSteps leaves the weights on its first
    # call and moves them on its second; the EMA advances on both
    tr = Trainer(tm, optimizer=optim.chain(optim.clip_by_global_norm(1.0),
                                           optim.MultiSteps(optim.adam(1e-3), 2)))
    s0 = tr.init_state()
    s1, _ = tr.train_step(s0, batch, generator=torch.Generator().manual_seed(0))
    s2, _ = tr.train_step(s1, batch, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(s1.params[k], p) for k, p in s0.params.items())
    assert not all(torch.equal(s2.params[k], p) for k, p in s1.params.items())
    assert s2.ema.step == 2 and s2.opt_state[1][1]["gradient_step"] == 1


def test_profiler_window_and_metrics_file(tmp_path):
    """`profile_logdir` traces steps [1, 3) into one Chrome trace;
    `metrics_path` logs one row a step with the packed tokens."""
    tm = Transfusion(transformer=TCFG["head-major"], device="cpu", **CFG)
    logdir, path = tmp_path / "prof", tmp_path / "metrics.jsonl"
    tr = Trainer(tm, optimizer=optim.muon_adam_atan2(), metrics_path=str(path),
                 profile_logdir=str(logdir), profile_start_step=1, profile_num_steps=2)
    state = tr.init_state()
    for i in range(4):
        state, _ = tr.train_step(state, samples(3), generator=torch.Generator().manual_seed(i))
        assert os.path.exists(logdir) == (i >= 3)
    assert os.listdir(logdir) == ["trace_steps_1-3.json"]
    with open(logdir / "trace_steps_1-3.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and "grad_norm" in r for r in rows)
    assert "tokens_per_sec" in rows[1]


def test_create_ema_matches_jax():
    """`create_ema` over 4 updates (warm-up copy, then a blend every 2nd)
    against the JAX EMA; its cached `sample` runs on the EMA weights (= the
    JAX EMA's `sample`), and so does `generate_text_only`; the model's own
    weights are left as they were."""
    jm = JaxTransfusion(transformer=TCFG["head-major"], **CFG)
    tm = Transfusion(transformer=TCFG["head-major"], device="cpu", **CFG)
    params = init_params("head-major", seed=3)
    tm.load_flax(np_tree(params))
    live = {k: p.clone() for k, p in tm.core.state_dict().items()}
    kw = dict(beta=0.5, update_every=2, update_after_step=1)
    ema_j, ema_t = JaxEMA(jm, params, **kw), tm.create_ema(**kw)
    for i in range(4):
        # the fixed time-embedding frequencies are a buffer in the port, a
        # stop-gradient param in JAX: no optimizer moves them
        new = jax.tree_util.tree_map_with_path(
            lambda path, p, i=i: p if "fourier" in jax.tree_util.keystr(path)
            else p + 0.01 * (i + 1), params)
        ema_j.update(new)
        ema_t.update(core_params(tm, new))
    want = core_params(tm, ema_j.ema_params)
    for k, v in want.items():
        np.testing.assert_allclose(ema_t.ema_params[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    noise = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, 2, jm.som_ids[0]], np.int32)], max_length=8,
              modality_steps=4, init_modality_noise=noise, cfg_scale=3.0,
              text_temperature=0.0, cache_kv=True)
    out_j = ema_j.sample(rng=jax.random.PRNGKey(1), return_unprocessed_modalities=True, **kw)
    out_t = ema_t.sample(**kw)
    assert len(out_j) == len(out_t)
    for a, b in zip(out_t, out_j):
        if isinstance(a, tuple):
            np.testing.assert_allclose(a[1], np.asarray(b[1]), atol=1e-3)
        else:
            np.testing.assert_array_equal(a, np.asarray(b))
    # generate_text_only on the EMA weights: as a model that holds them
    twin = Transfusion(transformer=TCFG["head-major"], device="cpu", **CFG)
    twin.core.load_state_dict({**live, **ema_t.ema_params})
    prompt = np.asarray([[16, 1, 2, 3]], np.int32)
    np.testing.assert_array_equal(ema_t.generate_text_only(prompt, 10, temperature=0.0).numpy(),
                                  twin.generate_text_only(prompt, 10, temperature=0.0).numpy())
    assert all(torch.equal(p, live[k]) for k, p in tm.core.state_dict().items())
