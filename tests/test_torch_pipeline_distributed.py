"""PyTorch port: pipeline parallelism across 4 gloo processes
(`Trainer(mesh=, pipeline_microbatches=, pipeline_schedule=)`, one stage
per rank of the 'pipe' axis, the carries through `comm.exchange`) against
the JAX package's dense single-device Trainer, in float32 on the CPU.

Three optimizer steps (lr 1e-3; fused clip + Adam + EMA, or Muon with
Adam-atan2 on the rest, clip 0.5) from the same jittered weights
(`load_flax`) with the draws of the JAX key schedule
(`test_torch_training.draws_from_key`), on:

  * pipe 4, GPipe (M 8) and 1F1B (M 4);
  * data 2 x pipe 2, 1F1B (M 2: each data rank runs 4 rows);
  * fsdp 2 x pipe 2 (M 4) and tensor 2 x pipe 2 (M 8), GPipe: the stored
    shards gathered whole for the stages, as JAX's `P('pipe')` specs do;
  * pipe 4, GPipe, `optimizer=muon_adam_atan2(1e-3, 3e-4)`.

Each step's loss is the same on every rank and within rtol 2e-4 of JAX's
single-device loss (as `test_torch_distributed.py` holds the other
meshes), the grad norm within rtol 1e-4 (2e-4 under Muon); each rank
computed its stage's M microbatches a step and no fill or drain tick. On pipe 4 (1F1B) a run
saved after one step, restored by a new Trainer and continued gives the
uninterrupted losses within 1e-5. Each refusal of the pipelined Trainer
gives JAX's message. The twin `torchrun --nproc_per_node=4 -m
transfusion_tpu_torch.examples.train_distributed --device cpu --pipeline 4
--steps 2` exits 0. The model: dim 48, depth 4, 2 heads of 32,
unet_skips=False, flash (the plain version on the CPU); 8 samples packed
to n 32.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_context_parallel import REPO, launch
from tests.test_torch_pipeline import samples
from tests.test_torch_training import draws_from_key, jitter, np_tree
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from transfusion_tpu.training import optim as jax_optim
from transfusion_tpu.training.ema import init_ema as j_init_ema
from transfusion_tpu.training.trainer import Trainer as JaxTrainer
from transfusion_tpu.training.trainer import TrainState as JaxTrainState
from transfusion_tpu_torch import Transfusion

CFG = dict(num_text_tokens=32, dim_latent=8, modality_default_shape=(2, 2), pad_multiple=32)
TCFG = dict(dim=48, depth=4, dim_head=32, heads=2, unet_skips=False)
STEPS = 3
# name: (mesh, schedule, microbatches, optimizer)
RUNS = {
    "pipe4-gpipe": (dict(pipe=4), "gpipe", 8, "adam"),
    "pipe4-1f1b": (dict(pipe=4), "1f1b", 4, "adam"),
    "data2-pipe2-1f1b": (dict(data=2, pipe=2), "1f1b", 2, "adam"),
    "fsdp2-pipe2-gpipe": (dict(fsdp=2, pipe=2), "gpipe", 4, "adam"),
    "tensor2-pipe2-gpipe": (dict(tensor=2, pipe=2), "gpipe", 8, "adam"),
    "pipe4-gpipe-muon": (dict(pipe=4), "gpipe", 4, "muon_adam_atan2"),
}
RESUME = ("pipe4-1f1b-resume", dict(pipe=4), "1f1b", 4)
# name: (mesh, transformer options, trainer options); each refused as JAX
# refuses it
REFUSALS = {
    "no-pipe-axis": (None, {}, dict(pipeline_microbatches=4)),
    "pipe-1": (dict(data=4), {}, dict(pipeline_microbatches=4)),
    "unet-skips": (dict(pipe=4), dict(unet_skips=True), dict(pipeline_microbatches=4)),
    "residual-streams": (dict(pipe=4), dict(num_residual_streams=2),
                         dict(pipeline_microbatches=4)),
    "dropout": (dict(pipe=4), dict(dropout=0.1), dict(pipeline_microbatches=4)),
    "depth": (dict(pipe=4), dict(depth=2), dict(pipeline_microbatches=4)),
    "microbatches": (dict(pipe=4), {}, dict(pipeline_microbatches=2)),
    "schedule": (dict(pipe=4), {}, dict(pipeline_microbatches=4, pipeline_schedule="zb")),
    "1f1b-fsdp": (dict(fsdp=2, pipe=2), {}, dict(pipeline_microbatches=4,
                                                 pipeline_schedule="1f1b")),
    "1f1b-tensor": (dict(tensor=2, pipe=2), {}, dict(pipeline_microbatches=4,
                                                     pipeline_schedule="1f1b")),
    "grad-accumulation": (dict(pipe=4), {}, dict(pipeline_microbatches=4,
                                                 grad_accumulation=2)),
}


def jax_steps(jm, params, packed, optimizer):
    kw = dict(learning_rate=1e-3)
    if optimizer == "muon_adam_atan2":
        kw = dict(optimizer=jax_optim.muon_adam_atan2(1e-3, 3e-4))
    jtr = JaxTrainer(jm, **kw)
    state = JaxTrainState(params=params, opt_state=jtr.tx.init(params), ema=j_init_ema(params),
                          step=jnp.zeros((), jnp.int32))
    out = []
    for i in range(STEPS):
        state, met = jtr.train_step(state, jax.tree.map(jnp.asarray, packed),
                                    jax.random.PRNGKey(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def jax_refusal(case) -> str:
    mesh, topts, trainer = case
    jm = JaxTransfusion(transformer=dict(TCFG, attn_impl="dense", **topts), **CFG)
    with pytest.raises(AssertionError) as e:
        JaxTrainer(jm, mesh=None if mesh is None else jax_make_mesh(**mesh), **trainer)
    return str(e.value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm = JaxTransfusion(transformer=dict(TCFG, attn_impl="dense"), **CFG)
    params = jitter(jax.jit(lambda k: jm.core.init(k, method="init_all"))(jax.random.PRNGKey(0)))
    flax_np = np_tree(params)  # before the jitted steps donate the buffers
    packed = jm.pack(samples(), shift_friendly=True)
    assert packed.text.shape == (8, 33)
    draws = [draws_from_key(jax.random.PRNGKey(i), packed) for i in range(STEPS)]
    want = {opt: jax_steps(jm, jax.tree.map(jnp.copy, params), packed, opt)
            for opt in ("adam", "muon_adam_atan2")}
    packed_t = Transfusion(transformer=TCFG, device="cpu", **CFG).pack(samples(),
                                                                       shift_friendly=True)
    np.testing.assert_array_equal(packed_t.text, np.asarray(packed.text))
    cfg = dict(CFG, transformer=dict(TCFG, attn_impl="flash"))
    jobs = []
    for name, (mesh, schedule, M, opt) in RUNS.items():
        jobs.append(dict(kind="pipeline", name=name, mesh=mesh, cfg=cfg, flax=flax_np,
                         packed=packed_t, draws=draws, optimizer=opt, trainer=dict(
                             learning_rate=1e-3, pipeline_microbatches=M,
                             pipeline_schedule=schedule)))
    name, mesh, schedule, M = RESUME
    jobs.append(dict(kind="pipeline", name=name, mesh=mesh, cfg=cfg, flax=flax_np,
                     packed=packed_t, draws=draws, resume_after=1, trainer=dict(
                         learning_rate=1e-3, pipeline_microbatches=M,
                         pipeline_schedule=schedule)))
    jobs.append(dict(kind="pipeline_refuse", name="refusals", cfg=CFG, cases={
        k: dict(mesh=m, transformer=dict(TCFG, attn_impl="flash", **t), trainer=tr)
        for k, (m, t, tr) in REFUSALS.items()}))
    return want, launch(tmp_path_factory.mktemp("pipe"), 4, jobs)


# a rank's stored shard ([out, in]; whole: to_qk [128, 48], text_embed [166, 48])
SHARDS = {
    "fsdp2-pipe2-gpipe": {"transformer.blocks.0.attn.to_qk.weight": (128, 24),
                          "text_embed.weight": (166, 24)},
    "tensor2-pipe2-gpipe": {"transformer.blocks.0.attn.to_qk.weight": (64, 48),
                            "text_embed.weight": (83, 48)},
}


@pytest.mark.parametrize("name", list(RUNS))
def test_pipelined_trainer_matches_jax_single_device(runs, name):
    mesh, schedule, M, opt = RUNS[name]
    want, ranks = runs
    losses = [[m["loss"] for m in r[name]["metrics"]] for r in ranks]
    assert all(ls == losses[0] for ls in losses), f"ranks disagree: {losses}"
    np.testing.assert_allclose(losses[0], [w[0] for w in want[opt]], rtol=2e-4)
    norms = [m["grad_norm"] for m in ranks[0][name]["metrics"]]
    # Muon's bf16 Newton-Schulz amplifies the two sides' float32 rounding
    # along each gradient's small singular directions, so the weights after
    # its first update part a little more (test_torch_optim.py)
    np.testing.assert_allclose(norms, [w[1] for w in want[opt]],
                               rtol=1e-4 if opt == "adam" else 2e-4)
    # each rank computed its stage's M microbatches a step, and no bubble
    # tick; 1F1B also ran the head of each on the last stage
    pipe = mesh["pipe"]
    for rank, r in enumerate(ranks):
        for calls in r[name]["stage_calls"]:
            got = calls[schedule]
            assert got["forward"] == got["backward"] == M, (rank, calls)
            if schedule == "1f1b":
                assert got["head"] == (M if rank % pipe == pipe - 1 else 0), (rank, calls)
    # stored as fsdp / tensor shards, computed whole
    shapes = ranks[0][name]["shapes"]
    for k, want in SHARDS.get(name, {}).items():
        assert shapes[k] == want, (k, shapes[k])


def test_pipelined_checkpoint_resume(runs):
    want, ranks = runs
    for r in ranks:
        res = r[RESUME[0]]
        full = [m["loss"] for m in res["metrics"]]
        np.testing.assert_allclose(full, [w[0] for w in want["adam"]], rtol=2e-4)
        assert res["restored_equal"]
        np.testing.assert_allclose([m["loss"] for m in res["resumed"]], full[1:], rtol=1e-5)


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pipeline_refusals_give_jax_messages(runs, case):
    _, ranks = runs
    got = {r["refusals"][case] for r in ranks}
    assert got == {jax_refusal(REFUSALS[case])}


def test_distributed_twin_pipeline(tmp_path):
    """The twin's --pipeline 4 under torchrun in 4 gloo processes: exit code
    0 within 120 s, the JAX script's mesh and microbatch choice, and the
    same finite first loss on every rank."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=4", "-m",
                        "transfusion_tpu_torch.examples.train_distributed", "--device", "cpu",
                        "--pipeline", "4", "--steps", "2"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "mesh: data=1 pipe=4 microbatches=8 batch=8" in r.stdout
    firsts = [ln for ln in r.stdout.splitlines() if ln.startswith("1: ")]
    assert len(firsts) == 4 and len(set(firsts)) == 1 and np.isfinite(float(firsts[0][3:]))
