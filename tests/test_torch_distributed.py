"""PyTorch port: `Trainer(mesh=)` in 4 gloo processes against the JAX
package's dense single-device Trainer, in float32 on the CPU.

Three optimizer steps (fused clip + Adam + EMA, lr 1e-3) from the same
jittered weights (`load_flax`) with the draws of the JAX key schedule
(`test_torch_training.draws_from_key`), on four meshes:

  * data 2 x context 2, attn_impl 'ring';
  * context 4, attn_impl 'cp_allgather';
  * data 2 x fsdp 2;
  * data 2 x tensor 2 (heads, GEGLU inner width and vocab split).

Each step's loss on every rank is the same, and within rtol 2e-4 of JAX's
dense single-device loss (as `tests/test_context_parallel.py::
test_train_data_x_context_matches_single_device` holds JAX's own meshes).
On an fsdp 2 x tensor 2 mesh, a run saved after one step, restored by a
new Trainer and continued gives the uninterrupted losses within 1e-5, and
restore hands back the saved shards exactly. The model (dim 48, 2 heads of
32, inner width 128, vocab 166) divides every split, and its attention at
n 32 takes the flash route per shard (the plain version on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_context_parallel import launch
from tests.test_torch_training import draws_from_key, jitter, np_tree
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch import Transfusion

CFG = dict(num_text_tokens=32, dim_latent=8, modality_default_shape=(2, 2), pad_multiple=32)
TCFG = dict(dim=48, depth=2, dim_head=32, heads=2)
STEPS = 3
MESHES = {
    "data2-context2-ring": (dict(data=2, context=2), "ring"),
    "context4-allgather": (dict(context=4), "cp_allgather"),
    "data2-fsdp2": (dict(data=2, fsdp=2), "flash"),
    "data2-tensor2": (dict(data=2, tensor=2), "flash"),
}
RESUME = ("fsdp2-tensor2-resume", dict(fsdp=2, tensor=2))
# mesh, attn_impl, options: grad accumulation with the velocity term's EMA
# forward; a custom optimizer (Adam-atan2, the unfused path) with ring
# attention; train_steps cycling two packed batches with the all-gather
COMPARE = {
    "data2-tensor2-accum-velocity": (dict(data=2, tensor=2), "flash", dict(trainer=dict(
        grad_accumulation=2, velocity_consistency=True, ema_update_after_step=0,
        ema_update_every=1))),
    "data2-context2-ring-adam-atan2": (dict(data=2, context=2), "ring",
                                       dict(optimizer="adam_atan2")),
    "context4-allgather-train-steps": (dict(context=4), "cp_allgather",
                                       dict(train_steps=True)),
}


def batch():
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 32, 6).astype(np.int32),
             (0, rng.standard_normal((2, 2, 8)).astype(np.float32)),
             rng.integers(0, 32, 3).astype(np.int32)] for _ in range(4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm = JaxTransfusion(transformer=dict(TCFG, attn_impl="dense"), **CFG)
    params = jitter(jax.jit(lambda k: jm.core.init(k, method="init_all"))(jax.random.PRNGKey(0)))
    flax_np = np_tree(params)  # before the jitted steps donate the buffers
    jtr = JaxTrainer(jm, learning_rate=1e-3)
    state = JaxTrainState(params=params, opt_state=jtr.tx.init(params), ema=j_init_ema(params),
                          step=jnp.zeros((), jnp.int32))
    packed = jm.pack(batch(), shift_friendly=True)
    assert packed.text.shape == (4, 33)
    want, draws = [], []
    for i in range(STEPS):
        rng = jax.random.PRNGKey(i)
        draws.append(draws_from_key(rng, packed))
        state, met = jtr.train_step(state, jax.tree.map(jnp.asarray, packed), rng)
        want.append((float(met["loss"]), float(met["grad_norm"])))
    # the port's own packer (the workers import no JAX); the same arrays
    packed_t = Transfusion(transformer=TCFG, device="cpu", **CFG).pack(batch(),
                                                                       shift_friendly=True)
    np.testing.assert_array_equal(packed_t.text, np.asarray(packed.text))
    common = dict(kind="trainer", cfg=dict(CFG, transformer=TCFG), flax=flax_np,
                  packed=packed_t, draws=draws, trainer=dict(learning_rate=1e-3))
    jobs = [dict(common, name=k, mesh=mesh, cfg=dict(CFG, transformer=dict(TCFG, attn_impl=impl)))
            for k, (mesh, impl) in MESHES.items()]
    jobs.append(dict(common, name=RESUME[0], mesh=RESUME[1], resume_after=1,
                     cfg=dict(CFG, transformer=dict(TCFG, attn_impl="flash"))))
    # the other Trainer options on a mesh, against the same Trainer without one
    packs = [Transfusion(transformer=TCFG, device="cpu", **CFG).pack(batch()[i::2],
                                                                     shift_friendly=True)
             for i in range(2)]
    latents = np.random.default_rng(1).standard_normal((4, 2, 2, 8)).astype(np.float32)
    for name, (mesh, impl, extra) in COMPARE.items():
        jobs.append(dict(kind="compare", name=name, mesh=mesh, impl=impl, flax=flax_np,
                         cfg=dict(CFG, transformer=TCFG), packed=packs, latents=latents,
                         trainer=dict(learning_rate=1e-3, **extra.get("trainer", {})),
                         **{k: v for k, v in extra.items() if k != "trainer"}))
    return want, launch(tmp_path_factory.mktemp("dist"), 4, jobs)


# a rank's stored shard of a few parameters ([out, in]; whole: to_qk [128, 48],
# proj_in [256, 48], to_out [48, 64], text_embed [166, 48])
SHARDS = {
    "data2-fsdp2": {"transformer.blocks.0.attn.to_qk.weight": (128, 24),
                    "transformer.blocks.0.ff.proj_in.weight": (256, 24),
                    "transformer.blocks.0.attn.to_out.weight": (24, 64),
                    "text_embed.weight": (166, 24)},
    "data2-tensor2": {"transformer.blocks.0.attn.to_qk.weight": (64, 48),
                      "transformer.blocks.0.ff.proj_in.weight": (128, 48),
                      "transformer.blocks.0.attn.to_out.weight": (48, 32),
                      "text_embed.weight": (83, 48)},
}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_steps_match_jax_single_device(runs, mesh):
    """Losses within rtol 2e-4 and grad norms within rtol 1e-4 (the clip's
    norm over every shard) of JAX's, the same on every rank."""
    want, ranks = runs
    losses = [[m["loss"] for m in r[mesh]["metrics"]] for r in ranks]
    assert all(ls == losses[0] for ls in losses), f"ranks disagree: {losses}"
    np.testing.assert_allclose(losses[0], [w[0] for w in want], rtol=2e-4)
    norms = [m["grad_norm"] for m in ranks[0][mesh]["metrics"]]
    np.testing.assert_allclose(norms, [w[1] for w in want], rtol=1e-4)
    for k, shape in SHARDS.get(mesh, {}).items():
        assert all(r[mesh]["shapes"][k] == shape for r in ranks), k


@pytest.mark.parametrize("name", list(COMPARE))
def test_mesh_options_match_meshless_trainer(runs, name):
    """Grad accumulation with the velocity-consistency term (its EMA
    forward on the gathered EMA shards), a custom optimizer on a data x
    context mesh, and `train_steps`: each step's metrics within rtol 2e-4
    of the same Trainer without a mesh (a flash model of the same weights,
    the same seeded draws), the same on every rank; and the modality-only
    forward, whose attention on a CP model is the dense online update over
    the context axis, within 1e-5."""
    _, ranks = runs
    for r in ranks:
        got, want = r[name]["mesh"], r[name]["plain"]
        assert got["metrics"] == ranks[0][name]["mesh"]["metrics"]
        assert len(got["metrics"]) == len(want["metrics"]) >= 1
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, err_msg=f"{name} {k}")
        np.testing.assert_allclose(got["forward_modality"], want["forward_modality"], rtol=1e-5)
    if "velocity" in name:
        assert "velocity_loss_0" in ranks[0][name]["mesh"]["metrics"][0]


def test_mesh_checkpoint_resume(runs):
    want, ranks = runs
    for r in ranks:
        res = r[RESUME[0]]
        full = [m["loss"] for m in res["metrics"]]
        resumed = [m["loss"] for m in res["resumed"]]
        assert res["restored_equal"]
        np.testing.assert_allclose(full, [w[0] for w in want], rtol=2e-4)
        np.testing.assert_allclose(resumed, full[1:], rtol=1e-5)
