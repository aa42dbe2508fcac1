"""The PyTorch port stands alone: it imports with `jax`, `flax`, `optax`,
`jaxtyping` and `transfusion_tpu` blocked (every module, the example twins
included), builds a small model on the CPU, serves from it
(batched text, uncached `sample`, `sample_batch`, `generate_modality_only`,
both continuous-batching engines) and takes a training step, takes a
velocity-consistency step and samples from an image model (encoder,
decoder, U-Net halves, pos-emb), takes a LASER + 4-stream step through
`Trainer(optimizer=muon_adam_atan2(...))`, feeds a training step from a
`PackingLoader`, loads a transfusion-pytorch state_dict with
`port_from_reference`, loads the gloo worker script of the parallel tests
and takes a `Trainer(mesh=)` step of a ring-attention model on a one-rank
gloo group (`transfusion_tpu_torch/parallel/`), runs the pipelined loss
on both schedules over 2 stages in one process (`LocalStages`, which
`Trainer(mesh=)` refuses), and its entry points default to the card
(raising when there is none)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    sys.modules["optax"] = None
    sys.modules["jaxtyping"] = None
    sys.modules["transfusion_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)

    import transfusion_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        transfusion_tpu_torch.__path__, "transfusion_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert not any(k in ("jax", "optax") or k.startswith(("jax.", "flax", "optax.", "jaxtyping",
                                                          "transfusion_tpu."))
                   for k, v in sys.modules.items() if v is not None), "JAX was imported"
    assert "transfusion_tpu_torch.examples.serve_text" in names

    from transfusion_tpu_torch import Transfusion
    cfg = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,),
               pad_multiple=16,
               transformer=dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="flash"))
    m = Transfusion(device="cpu", **cfg)
    toks = m.generate_text_batch([np.asarray([8, 1, 2])], max_new_tokens=3, temperature=0.0)
    assert toks.shape == (1, 3)

    noise = np.ones((4, 16), np.float32)
    out = m.sample(prompt=[np.asarray([1, m.som_ids[0]])], max_length=6, modality_steps=2,
                   text_temperature=0.0, init_modality_noise=noise)
    assert sum(isinstance(o, tuple) for o in out) == 1
    outs = m.sample_batch([[np.asarray([1, 2])], [np.asarray([3, m.som_ids[0]])]],
                          max_length=6, modality_steps=2, text_temperature=0.0,
                          init_modality_noise=noise)
    assert len(outs) == 2 and any(isinstance(o, tuple) for o in outs[1])
    lat = m.generate_modality_only(batch_size=2, modality_steps=2,
                                   generator=torch.Generator().manual_seed(0))
    assert lat.shape == (2, 4, 16) and bool(torch.isfinite(lat).all())

    from transfusion_tpu_torch.models.engine import ServingEngine
    from transfusion_tpu_torch.models.engine_mm import MultimodalServingEngine
    from transfusion_tpu_torch.training.metrics import MetricsLogger
    log = MetricsLogger()
    eng = ServingEngine(m, max_batch=2, max_seq_len=64, decode_chunk=4, metrics=log)
    done = eng.run([np.asarray([8, 1, 2]), np.asarray([8, 3]), np.asarray([8, 4, 5, 6])], 5)
    assert sorted(len(r.tokens) for r in done) == [5, 5, 5] and len(log.history) >= 2
    assert [len(t) for t in eng.serve([np.asarray([8, 2]), np.asarray([8, 7, 7])], [3, 2])] \
        == [3, 2]
    mm = MultimodalServingEngine(m, max_requests=1, max_seq_len=64, modality_steps=2,
                                 text_temperature=0.0, init_modality_noise=noise)
    fin = mm.run([[np.asarray([1, 2])], [np.asarray([3, m.som_ids[0]])]], max_length=6)
    assert len(fin) == 2 and any(isinstance(o, tuple) for f in fin for o in f.output)

    from transfusion_tpu_torch.training import Trainer
    trainer = Trainer(m)
    batch = [[np.asarray([1, 2, 3], np.int32), np.ones((4, 16), np.float32)]]
    state, metrics = trainer.train_step(trainer.init_state(), batch,
                                        generator=torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))

    # the image model: patch encoder / decoder, U-Net halves, pos-emb,
    # reconstruction and velocity-consistency losses
    from transfusion_tpu_torch.models.modality_io import (
        PatchDecoder, PatchEncoder, SameConv2d, SameConvTranspose2d)
    im = Transfusion(device="cpu", num_text_tokens=8, dim_latent=8, modality_default_shape=(4, 4),
                     pad_multiple=16, modality_encoder=PatchEncoder(),
                     modality_decoder=PatchDecoder(), add_pos_emb=True, modality_num_dim=2,
                     pre_post_transformer_enc_dec=(SameConv2d(8, 32), SameConvTranspose2d(32, 8)),
                     reconstruction_loss_weight=0.1,
                     transformer=dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="flash"))
    img = np.random.default_rng(0).uniform(size=(8, 8, 2)).astype(np.float32)
    vt = Trainer(im, velocity_consistency=True)
    state, metrics = vt.train_step(vt.init_state(), [[np.asarray([1, 2], np.int32), (0, img)]],
                                   generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["velocity_loss_0"])) and "recon_loss_0" in metrics
    noise = np.ones((16, 8), np.float32)
    out = im.sample(prompt=[np.asarray([1, im.som_ids[0]])], max_length=6, modality_steps=2,
                    text_temperature=0.0, init_modality_noise=noise, cache_kv=True)
    assert [o[1].shape for o in out if isinstance(o, tuple)] == [(8, 8, 2)]
    outs = im.sample_batch([(0, img), [np.asarray([3, im.som_ids[0]])]], max_length=6,
                           modality_steps=2, text_temperature=0.0, init_modality_noise=noise)
    assert all(o[1].shape == (8, 8, 2) for r in outs for o in r if isinstance(o, tuple))

    # the recipes' options: LASER, 4 residual streams, fused projections, Muon
    from transfusion_tpu_torch.training import muon_adam_atan2
    lm = Transfusion(device="cpu", **dict(cfg, transformer=dict(
        cfg["transformer"], attn_laser=True, num_residual_streams=4, fuse_projections=True)))
    lt = Trainer(lm, optimizer=muon_adam_atan2(3e-4, 3e-4))
    state, metrics = lt.train_step(lt.init_state(), batch,
                                   generator=torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert "transformer.blocks.1.attn.to_value_residual_mix.weight" in lm.muon_parameters()

    # a PackingLoader feeding the Trainer, and a reference checkpoint
    from transfusion_tpu_torch.data.dataloader import PackingLoader
    from transfusion_tpu_torch.models.port import export_to_reference, port_from_reference
    loader = PackingLoader(m, [b[0] for b in [batch] * 4], batch_size=2)
    try:
        state, metrics = trainer.train_step(trainer.init_state(), next(loader),
                                            generator=torch.Generator().manual_seed(1))
    finally:
        loader.close()
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    sd = export_to_reference(m)
    fresh = Transfusion(device="cpu", seed=5, **cfg)
    port_from_reference(sd, fresh)
    assert all(torch.equal(fresh.core.state_dict()[k], v)
               for k, v in m.core.state_dict().items())

    # the parallel path: the gloo worker script, and Trainer(mesh=) with ring
    # attention on a one-rank group
    import importlib.util, os, tempfile
    import torch.distributed as dist
    spec = importlib.util.spec_from_file_location(
        "torch_parallel_worker", os.path.join(os.getcwd(), "tests", "torch_parallel_worker.py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from transfusion_tpu_torch.parallel import make_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=0, world_size=1)
        try:
            mesh = make_mesh(device="cpu")
            rm = Transfusion(device="cpu", **dict(cfg, transformer=dict(
                cfg["transformer"], attn_impl="ring", mesh=mesh)))
            rt = Trainer(rm, mesh=mesh)
            state, metrics = rt.train_step(rt.init_state(), batch,
                                           generator=torch.Generator().manual_seed(0))
        finally:
            dist.destroy_process_group()
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))

    # the pipeline: both schedules on 2 stages in this process, and the
    # Trainer refusing the one-process driver for a mesh
    assert {"transfusion_tpu_torch.parallel.pipeline", "transfusion_tpu_torch.parallel."
            "pipeline_1f1b", "transfusion_tpu_torch.models.pipeline_loss"} <= set(names)
    from transfusion_tpu_torch.parallel.pipeline import LocalStages
    pm = Transfusion(device="cpu", **dict(cfg, transformer=dict(cfg["transformer"],
                                                                unet_skips=False)))
    packed = pm.pack(batch * 2, shift_friendly=True).to_torch("cpu")
    for schedule in ("gpipe", "1f1b"):
        params = {k: p.detach().clone().requires_grad_(True)
                  for k, p in pm.core.named_parameters()}
        loss = pm.loss(packed=packed, params=params, pipeline=(LocalStages(2), 2, schedule),
                       generator=torch.Generator().manual_seed(0))
        loss.backward()
        assert np.isfinite(float(loss)) and params["to_text_logits.weight"].grad is not None
    for kw in (dict(), dict(pipeline_microbatches=2)):
        try:
            Trainer(pm, mesh=LocalStages(2), **kw)
        except (TypeError, ValueError) as e:
            assert "make_mesh" in str(e)
        else:
            raise AssertionError("Trainer(mesh=LocalStages(2)) must raise")
    assert not any(k in ("jax", "optax") or k.startswith(("jax.", "flax", "optax.", "jaxtyping",
                                                          "transfusion_tpu."))
                   for k, v in sys.modules.items() if v is not None), "JAX was imported"

    if not torch.cuda.is_available():
        try:
            Transfusion(**cfg)
        except RuntimeError as e:
            assert "device='cpu'" in str(e)
        else:
            raise AssertionError("Transfusion() without a GPU must raise")
    print("OK", len(names))
    """
)


def test_port_imports_without_jax_and_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")
    assert int(r.stdout.split()[1]) >= 20  # every module of the package was imported
