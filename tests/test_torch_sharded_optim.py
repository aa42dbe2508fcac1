"""PyTorch port: custom optimizer chains on meshes that shard parameters
(`Trainer(mesh=, optimizer=)` with 'fsdp' or 'tensor' > 1; the update runs
inside `training.optim.sharded`) in 4 gloo processes, against the JAX
package's single-device Trainer given the same optax chain, in float32 on
the CPU.

The model of `test_torch_distributed.py` (dim 48, 2 layers, 2 heads of 32,
inner width 128, vocab 166: every split divides), the same jittered
weights (`load_flax`) and the draws of the JAX key schedule
(`test_torch_training.draws_from_key`), 3 optimizer steps:

  * the recipes' chains on fsdp 2 x tensor 2, data 2 x fsdp 2 and data 2 x
    tensor 2: `examples/train_image_only.py`'s chain(clip_by_global_norm(
    0.5), muon_adam_atan2(3e-4, 3e-4)) with the Trainer's clip off (the
    clip's global norm is the caller's), and `examples/train_text_only.py`'s
    MultiSteps(adam(1e-3), 2) behind the Trainer's clip 0.5. Losses and
    grad norms within rtol 2e-4 of JAX's (the bounds
    `test_torch_pipeline_distributed.py` holds Muon to), the same on every
    rank;
  * Muon's update of whole matrices given to it as shards (a fused 'halves'
    matrix, a column- and a row-parallel one) equals its update of the
    whole matrices exactly, and `global_norm` of the shards equals the
    whole tensors' within 1e-6;
  * a `muon_adam_atan2` state on fsdp 2 x tensor 2 goes through
    `Trainer._unshard` (every moment of every `multi_transform` label
    whole) and `Trainer._shard` back to itself exactly; a run saved after
    step 1, restored by a new Trainer and continued gives the uninterrupted
    losses within 1e-5, and the restored optimizer state equals the saved
    one exactly;
  * when each rank's gradients differ in their last bits before the
    reduction (as the card's attention backward makes them), the ranks
    that hold a replica of a shard still hold equal bytes after two steps;
  * GPipe on fsdp 2 x pipe 2 (unet_skips=False, M 4) with
    `optimizer=adam_atan2(1e-3)`: losses and grad norms within rtol 2e-4
    of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.test_torch_context_parallel import launch
from tests.test_torch_distributed import CFG, TCFG, batch
from tests.test_torch_training import draws_from_key, jitter, np_tree
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.training import optim as jax_optim
from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch import Transfusion

STEPS = 3
MESHES = {"fsdp2-tensor2": dict(fsdp=2, tensor=2), "data2-fsdp2": dict(data=2, fsdp=2),
          "data2-tensor2": dict(data=2, tensor=2)}
# the port's optimizer (by its name in torch_parallel_worker.make_optimizer):
# (Trainer clip, the same chain in optax)
RECIPES = {
    "image_recipe": (None, lambda: optax.chain(optax.clip_by_global_norm(0.5),
                                               jax_optim.muon_adam_atan2(3e-4, 3e-4))),
    "multisteps_adam": (0.5, lambda: optax.MultiSteps(optax.adam(1e-3), every_k_schedule=2)),
}
CHECKPOINT = ("checkpoint-fsdp2-tensor2", dict(fsdp=2, tensor=2), "muon_adam_atan2",
              lambda: jax_optim.muon_adam_atan2(1e-3, 3e-4))
GPIPE = ("gpipe-fsdp2-pipe2", dict(fsdp=2, pipe=2), "adam_atan2",
         lambda: jax_optim.adam_atan2(1e-3))
PIPE_TCFG = dict(TCFG, unet_skips=False)
# whole updates handed to Muon as fsdp 2 x tensor 2 shards ([out, in])
ORTH = {"halves": ("transformer.blocks.0.ff.proj_in.weight", (256, 48)),
        "column-parallel": ("transformer.blocks.0.attn.to_v.weight", (64, 48)),
        "row-parallel": ("transformer.blocks.0.attn.to_out.weight", (48, 64))}


def jax_run(tcfg, tx, clip, seed=0):
    """(flax weights as numpy, the packed batch, the draws, [(loss, grad
    norm)] of JAX's single-device Trainer over STEPS steps)."""
    jm = JaxTransfusion(transformer=dict(tcfg, attn_impl="dense"), **CFG)
    params = jitter(jax.jit(lambda k: jm.core.init(k, method="init_all"))(
        jax.random.PRNGKey(seed)))
    flax_np = np_tree(params)  # before the jitted steps donate the buffers
    jtr = JaxTrainer(jm, optimizer=tx, grad_clip_norm=clip)
    state = JaxTrainState(params=params, opt_state=jtr.tx.init(params), ema=j_init_ema(params),
                          step=jnp.zeros((), jnp.int32))
    packed = jm.pack(batch(), shift_friendly=True)
    out, draws = [], []
    for i in range(STEPS):
        rng = jax.random.PRNGKey(i)
        draws.append(draws_from_key(rng, packed))
        state, met = jtr.train_step(state, jax.tree.map(jnp.asarray, packed), rng)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return flax_np, draws, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    packed = Transfusion(transformer=TCFG, device="cpu", **CFG).pack(batch(), shift_friendly=True)
    cfg = dict(CFG, transformer=dict(TCFG, attn_impl="flash"))
    want, jobs = {}, []
    for opt, (clip, tx) in RECIPES.items():
        flax_np, draws, want[opt] = jax_run(TCFG, tx(), clip)
        for mesh_name, mesh in MESHES.items():
            jobs.append(dict(kind="trainer", name=f"{opt}-{mesh_name}", mesh=mesh, cfg=cfg,
                             flax=flax_np, packed=packed, draws=draws, optimizer=opt,
                             trainer=dict(grad_clip_norm=clip)))
    name, mesh, opt, tx = CHECKPOINT
    flax_np, draws, want[name] = jax_run(TCFG, tx(), 0.5)
    jobs.append(dict(kind="trainer", name=name, mesh=mesh, cfg=cfg, flax=flax_np, packed=packed,
                     draws=draws, optimizer=opt, resume_after=1, trainer={}))
    jobs.append(dict(kind="state_roundtrip", name="roundtrip", mesh=mesh, cfg=cfg, flax=flax_np,
                     packed=packed, draws=draws[0]))
    jobs.append(dict(kind="replicas", name="replicas", mesh=mesh, cfg=cfg, flax=flax_np,
                     packed=packed, draws=draws))
    name, mesh, opt, tx = GPIPE
    flax_np, draws, want[name] = jax_run(PIPE_TCFG, tx(), 0.5)
    jobs.append(dict(kind="pipeline", name=name, mesh=mesh, flax=flax_np, packed=packed,
                     draws=draws, optimizer=opt,
                     cfg=dict(CFG, transformer=dict(PIPE_TCFG, attn_impl="flash")),
                     trainer=dict(pipeline_microbatches=4, pipeline_schedule="gpipe")))
    rng = np.random.default_rng(3)
    jobs.append(dict(kind="orth", name="orth", mesh=dict(fsdp=2, tensor=2), cfg=cfg, updates={
        k: rng.standard_normal(shape).astype(np.float32) for k, shape in ORTH.values()}))
    return want, launch(tmp_path_factory.mktemp("sharded_optim"), 4, jobs)


def hold_against_jax(ranks, name, want):
    losses = [[m["loss"] for m in r[name]["metrics"]] for r in ranks]
    assert all(ls == losses[0] for ls in losses), f"ranks disagree: {losses}"
    np.testing.assert_allclose(losses[0], [w[0] for w in want], rtol=2e-4, err_msg=name)
    norms = [[m["grad_norm"] for m in r[name]["metrics"]] for r in ranks]
    assert all(ns == norms[0] for ns in norms), f"ranks disagree: {norms}"
    np.testing.assert_allclose(norms[0], [w[1] for w in want], rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_chain_on_sharded_mesh_matches_jax(runs, recipe, mesh):
    want, ranks = runs
    hold_against_jax(ranks, f"{recipe}-{mesh}", want[recipe])


@pytest.mark.parametrize("case", list(ORTH))
def test_sharded_newton_schulz_equals_whole(runs, case):
    """Every rank's Muon update of its shard is the shard of the whole
    matrix's update, bit for bit, and the shards join into it."""
    _, ranks = runs
    name, shape = ORTH[case]
    for r in ranks:
        res = r["orth"]
        assert "fsdp" in res["specs"][name] and "tensor" in res["specs"][name]
        equal_shard, equal_whole, shard_shape = res[name]
        assert equal_shard and equal_whole, (case, res[name])
        assert shard_shape == (shape[0] // 2, shape[1] // 2)
        sharded, whole = res["norm"]
        np.testing.assert_allclose(sharded, whole, rtol=1e-6)


def test_multi_transform_state_unshards_and_reshards(runs):
    """`_map_param_dicts` takes every label's moments (a subset of the
    parameter names each) through the gather and the re-shard."""
    _, ranks = runs
    for r in ranks:
        res = r["roundtrip"]
        assert res["whole_shapes"] and res["some_sharded"] and res["roundtrip_equal"], res
        assert any("to_out" in k for k in res["names"]) and any(
            "text_embed" in k for k in res["names"])


def test_replicas_stay_equal_when_ranks_gradients_differ(runs):
    """Every shard that more than one rank holds (a spec without 'fsdp' or
    without 'tensor') has the same bytes on each of them."""
    _, ranks = runs
    specs = ranks[0]["replicas"]["specs"]
    replicated = 0
    for k, spec in specs.items():
        groups = {}
        for r, res in enumerate(ranks):  # rank = 2 * fsdp index + tensor index
            key = (r // 2 if "fsdp" in spec else None, r % 2 if "tensor" in spec else None)
            groups.setdefault(key, set()).add(res["replicas"]["bytes"][k])
        assert all(len(held) == 1 for held in groups.values()), (k, spec)
        replicated += len(groups) < len(ranks)
    assert replicated > 10


def test_sharded_muon_checkpoint_resume(runs):
    want, ranks = runs
    name = CHECKPOINT[0]
    hold_against_jax(ranks, name, want[name])
    for r in ranks:
        res = r[name]
        assert res["restored_equal"] and res["restored_opt_equal"]
        full = [m["loss"] for m in res["metrics"]]
        np.testing.assert_allclose([m["loss"] for m in res["resumed"]], full[1:], rtol=1e-5)


def test_gpipe_fsdp_pipe_custom_optimizer_matches_jax(runs):
    want, ranks = runs
    hold_against_jax(ranks, GPIPE[0], want[GPIPE[0]])
    for r in ranks:
        assert r[GPIPE[0]]["shapes"]["text_embed.weight"] == (166, 24)
