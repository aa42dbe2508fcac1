"""PyTorch port: pipeline parallelism in one process (`parallel/pipeline.py`,
`parallel/pipeline_1f1b.py`, `models/pipeline_loss.py`) against the JAX
package, in float32 on the CPU.

The P stages run in this process (`LocalStages(P)`: the engines' own
schedule code, the carries handed over in memory), P in {2, 4} and M in
{4, 8}. A model of dim 64, depth 4, 2 heads of 32, unet_skips=False, on
the dense route and on the flash route (its plain version on CPU tensors);
8 samples packed to n 32 with latent groups of two shapes, so microbatches
hold different groups. Weights and draws from JAX (`load_flax`, the key
schedule of `_loss_impl`), inputs from numpy seeds.

Held:
  * the GPipe trunk against JAX's `pipeline_transformer_forward` on
    `make_mesh(pipe=4)` over the suite's virtual CPU devices (2e-5, as
    `tests/test_pipeline.py` holds JAX's own against its `Transformer`),
    and against the port's unpipelined `Transformer` (output 1e-5, the
    gradients of sum(out ** 2) 1e-4) under remat 'full' and 'dots' too;
  * the joint loss, its breakdown (rtol 1e-6, atol 1e-5: a time near 1
    puts the flow loss in the hundreds) and every parameter gradient
    (1e-4) of both schedules against JAX's single-device `_loss_impl`,
    with the velocity-consistency and reconstruction terms, with
    `ce_chunk_size`, and under remat;
  * that no stage computes a fill or drain tick: per call, P * M stage
    forwards and P * M stage backwards (and M heads for 1F1B), where
    computing every tick would be P (M + P - 1) or P (M + 2 (P - 1));
  * the refusals of the engines themselves (loss_scales with a pipeline,
    an unknown schedule, 1F1B with M < P, a stack that cannot be split).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_training import core_params, draws_from_key, jitter, np_tree
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.models.transformer import Transformer as JaxTransformer
from transfusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from transfusion_tpu.parallel.pipeline import (
    pipeline_transformer_forward as jax_pipeline_forward,
)
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.ops.spans import spans_to_rotary_positions
from transfusion_tpu_torch.parallel.pipeline import (
    LocalStages,
    pipeline_blocks,
    pipeline_transformer_forward,
)
from transfusion_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b_grads

torch.set_num_threads(1)

CFG = dict(num_text_tokens=32, dim_latent=8, modality_default_shape=(2, 2), pad_multiple=32,
           prob_uncond=0.5)
TCFG = dict(dim=64, depth=4, dim_head=32, heads=2, unet_skips=False)
# per variant: extra model options, and whether the loss takes the EMA term
VARIANTS = {
    "plain": (dict(), False),
    "velocity": (dict(reconstruction_loss_weight=0.1), True),
    "chunk": (dict(ce_chunk_size=12), False),
}
# (schedule, P, M, route, variant, remat policy)
LOSS_CASES = [
    ("gpipe", 2, 4, "dense", "plain", None),
    ("gpipe", 4, 8, "flash", "plain", None),
    ("1f1b", 2, 4, "flash", "plain", None),
    ("1f1b", 4, 8, "dense", "plain", None),
    ("gpipe", 4, 4, "flash", "velocity", None),
    ("1f1b", 4, 4, "flash", "velocity", None),
    ("gpipe", 2, 4, "flash", "chunk", None),
    ("1f1b", 2, 8, "flash", "chunk", None),
    ("gpipe", 4, 4, "flash", "plain", "full"),
    ("gpipe", 2, 8, "dense", "plain", "dots"),
    ("1f1b", 4, 4, "flash", "plain", "full"),
    ("1f1b", 2, 4, "dense", "plain", "dots"),
]


def samples(seed=0, b=8):
    """b samples: text + a 2x2 latent + text, text alone, a 2x4 latent
    alone, in turn (two latent groups)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        if i % 3 == 0:
            out.append([rng.integers(0, 32, 5).astype(np.int32),
                        (0, rng.standard_normal((2, 2, 8)).astype(np.float32)),
                        rng.integers(0, 32, 3).astype(np.int32)])
        elif i % 3 == 1:
            out.append([rng.integers(0, 32, 9).astype(np.int32)])
        else:
            out.append([(0, rng.standard_normal((2, 4, 8)).astype(np.float32))])
    return out


def tcfg(route, remat=None):
    cfg = dict(TCFG, attn_impl=route)
    if remat is not None:
        cfg.update(remat=True, remat_policy=remat)
    return cfg


@pytest.fixture(scope="module")
def weights():
    """Jittered flax params and EMA params (the fourier frequencies, frozen
    in both packages, held by the EMA as by the model)."""
    jm = JaxTransfusion(transformer=tcfg("dense"), **CFG)
    params = jitter(jax.jit(lambda k: jm.core.init(k, method="init_all"))(jax.random.PRNGKey(0)))
    ema = jax.tree_util.tree_map_with_path(
        lambda path, e, p: p if "fourier_weights" in jax.tree_util.keystr(path) else e,
        jitter(params, seed=9, scale=0.02), params)
    return params, ema


def port_model(params, route, remat=None, **kw):
    tm = Transfusion(transformer=tcfg(route, remat), device="cpu", **dict(CFG, **kw))
    return tm.load_flax(np_tree(params))


@pytest.fixture(scope="module")
def batch():
    jm = JaxTransfusion(transformer=tcfg("dense"), **CFG)
    packed = jm.pack(samples(), shift_friendly=True)
    assert packed.text.shape == (8, 33) and len(packed.groups) == 2
    return packed


@pytest.fixture(scope="module")
def jax_refs(weights, batch):
    """JAX's single-device loss, breakdown and gradients per variant, and
    the draws of its key schedule."""
    params, ema = weights
    rng = jax.random.PRNGKey(7)
    draws = draws_from_key(rng, batch)
    assert bool((draws.cfg_uniform < 0.5).any()), "no sample's text was dropped"
    keys = jax.random.split(jax.random.split(rng, 4)[3], len(batch.groups))
    ema_noises = tuple(torch.tensor(np.asarray(jax.random.normal(k, g.latents.shape)))
                       for k, g in zip(keys, batch.groups))
    refs = {}
    for name, (kw, velocity) in VARIANTS.items():
        jm = JaxTransfusion(transformer=tcfg("dense"), **dict(CFG, **kw))

        def jloss(p, jm=jm, velocity=velocity):
            return jm._loss_impl(p, jax.tree.map(jnp.asarray, batch), rng, None,
                                 ema if velocity else None, prob_uncond=0.5,
                                 velocity_delta=1e-3, train=True)

        refs[name] = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return refs, draws, ema_noises


def case_id(case):
    return "-".join(str(c) for c in case if c is not None)


def reset_counts():
    pipeline_blocks.stage_calls.update(forward=0, backward=0)
    pipeline_1f1b_grads.stage_calls.update(forward=0, backward=0, head=0)


@pytest.mark.parametrize("case", LOSS_CASES, ids=[case_id(c) for c in LOSS_CASES])
def test_pipelined_loss_and_grads_match_jax(weights, batch, jax_refs, case):
    schedule, P, M, route, variant, remat = case
    params, ema = weights
    refs, draws, ema_noises = jax_refs
    (total_j, bd_j), grads_j = refs[variant]
    kw, velocity = VARIANTS[variant]
    tm = port_model(params, route, remat, **kw)
    packed = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    np.testing.assert_array_equal(packed.text, np.asarray(batch.text))
    if velocity:
        draws = dataclasses.replace(draws, ema_noises=ema_noises)
    leaves = {k: p.requires_grad_(True) for k, p in core_params(tm, params).items()}
    reset_counts()
    total, bd = tm._loss_impl(leaves, packed, draws, 0.5, ema_params=core_params(tm, ema)
                              if velocity else None, pipeline=(LocalStages(P), M, schedule))
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)

    # near t = 1 the x-prediction's 1 / (1 - t) puts the flow loss in the
    # hundreds (key 7 draws t 0.994): a relative bound, with 1e-5 absolute
    tol = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(total.item(), float(total_j), **tol)
    np.testing.assert_allclose(bd.text.item(), float(bd_j.text), **tol)
    for name in ("flow", "velocity", "recon"):
        want = getattr(bd_j, name)
        if want is not None:
            np.testing.assert_allclose(np.asarray([x.item() for x in getattr(bd, name)]),
                                       np.asarray(want, np.float64), err_msg=name, **tol)
    want = core_params(tm, grads_j)
    for (k, _), g in zip(leaves.items(), grads):
        g = torch.zeros_like(want[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    # the stages computed their microbatches and nothing else (the EMA
    # target's forward-only GPipe pass adds P * M forwards)
    fwd = P * M * (2 if velocity else 1)
    if schedule == "gpipe":
        assert pipeline_blocks.stage_calls == {"forward": fwd, "backward": P * M}
    else:
        assert pipeline_1f1b_grads.stage_calls == {"forward": P * M, "backward": P * M, "head": M}
        assert pipeline_blocks.stage_calls["forward"] == fwd - P * M


@pytest.mark.parametrize("schedule,P,M", [("gpipe", 4, 4), ("1f1b", 4, 4), ("gpipe", 2, 8),
                                          ("1f1b", 2, 8)])
def test_no_stage_computes_a_bubble_tick(weights, batch, schedule, P, M):
    """P * M stage forwards and backwards a call, not one per tick: JAX
    computes all P (M + P - 1) GPipe ticks (P (M + 2 (P - 1)) for 1F1B) and
    masks the fill and drain ones."""
    params, _ = weights
    tm = port_model(params, "flash")
    packed = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    draws = tm.make_draws(packed, torch.Generator().manual_seed(0))
    leaves = {k: p.requires_grad_(True) for k, p in core_params(tm, params).items()}
    reset_counts()
    total, _ = tm._loss_impl(leaves, packed, draws, 0.5, pipeline=(LocalStages(P), M, schedule))
    total.backward()
    ticks = M + P - 1 if schedule == "gpipe" else M + 2 * (P - 1)
    counts = (pipeline_blocks.stage_calls if schedule == "gpipe"
              else pipeline_1f1b_grads.stage_calls)
    assert counts["forward"] == counts["backward"] == P * M < P * ticks
    if schedule == "1f1b":
        assert counts["head"] == M


# (P, M, route, remat policy): the trunk against the unpipelined Transformer
TRUNK_CASES = [(2, 4, "dense", None), (4, 8, "flash", None), (4, 4, "dense", "full"),
               (2, 8, "flash", "dots")]


def trunk_inputs(batch, seed=1):
    rng = np.random.default_rng(seed)
    b, n = batch.text.shape[0], batch.text.shape[1] - 1
    x = rng.standard_normal((b, n, TCFG["dim"])).astype(np.float32)
    times = rng.uniform(size=batch.spans.shape[:2]).astype(np.float32)
    spans = np.asarray(batch.spans)
    rot = spans_to_rotary_positions(n, torch.tensor(spans)).numpy()
    return x, times, spans, rot


def test_gpipe_trunk_matches_jax_pipeline(weights, batch):
    params, _ = weights
    x, times, spans, rot = trunk_inputs(batch)
    t = JaxTransformer(dim=TCFG["dim"], dtype=jnp.float32,
                       **{k: v for k, v in tcfg("dense").items() if k != "dim"})
    mesh = jax_make_mesh(pipe=4)
    want = jax.jit(lambda p, *a: jax_pipeline_forward(
        p, t, mesh, microbatches=4, x=a[0], times_inst=a[1], spans=a[2], rotary_pos=a[3]))(
        params["params"]["transformer"], *map(jnp.asarray, (x, times, spans, rot)))
    tm = port_model(params, "dense")
    with torch.no_grad():
        got = pipeline_transformer_forward(tm.core.transformer, LocalStages(4), 4,
                                           torch.tensor(x), times_inst=torch.tensor(times),
                                           spans=torch.tensor(spans),
                                           rotary_pos=torch.tensor(rot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case", TRUNK_CASES, ids=[case_id(c) for c in TRUNK_CASES])
def test_gpipe_trunk_matches_transformer(weights, batch, case):
    P, M, route, remat = case
    params, _ = weights
    x, times, spans, rot = trunk_inputs(batch, seed=2)
    tm = port_model(params, route, remat)
    tr = tm.core.transformer
    kw = dict(times_inst=torch.tensor(times), spans=torch.tensor(spans),
              rotary_pos=torch.tensor(rot))
    tr.requires_grad_(True)
    names = [k for k, _ in tr.named_parameters()]
    outs, grads = [], []
    for pipelined in (False, True):
        xt = torch.tensor(x, requires_grad=True)
        out = (pipeline_transformer_forward(tr, LocalStages(P), M, xt, **kw) if pipelined
               else tr(xt, **kw)[0])
        g = torch.autograd.grad((out ** 2).sum(), [xt, *tr.parameters()], allow_unused=True)
        outs.append(out.detach())
        grads.append([torch.zeros(1) if t is None else t for t in g])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5)
    for name, a, b in zip(["x", *names], grads[0], grads[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-5, err_msg=name)


def test_engine_refusals(weights, batch):
    """What the engines refuse by themselves, with JAX's messages:
    loss_scales (gradient accumulation) with a pipeline, an unknown
    schedule, 1F1B with fewer microbatches than stages, and stacks that
    cannot be split into stages."""
    params, _ = weights
    tm = port_model(params, "flash")
    packed = tm.pack(samples(), shift_friendly=True).to_torch("cpu")
    draws = tm.make_draws(packed, torch.Generator().manual_seed(0))
    scales = tm.loss_denominators(packed, draws)
    for kw, match in (
            (dict(loss_scales=scales, pipeline=(LocalStages(2), 4)),
             "cannot combine with pipeline parallelism"),
            (dict(pipeline=(LocalStages(2), 4, "zero-bubble")), "unknown pipeline schedule"),
            (dict(pipeline=(LocalStages(4), 2, "1f1b")), "microbatches 2 must be >= pipe 4"),
            (dict(pipeline=(LocalStages(3), 4)), "depth 4 % pipe 3 != 0"),
            (dict(pipeline=(LocalStages(2), 3)), "batch 8 % microbatches 3 != 0")):
        with pytest.raises(ValueError, match=match):
            tm._loss_impl(None, packed, draws, 0.5, **kw)
    skips = Transfusion(transformer=dict(TCFG, unet_skips=True), device="cpu", **CFG)
    with pytest.raises(ValueError, match="pipeline requires unet_skips=False"):
        skips.loss(packed=packed, draws=draws, pipeline=(LocalStages(2), 4))
