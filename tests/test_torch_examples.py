"""The port's example twins (`transfusion_tpu_torch/examples/`) on the CPU:
each runs 2 steps with `--device cpu` in a temporary directory (in this
process, as `python -m` runs it) with a finite loss, and samples once where
its JAX script samples (the sampler's calls are counted); `serve_text`
runs every demo at a small width. Their own modules are held against the
flax modules of the JAX scripts with the same weights, within 1e-5: the
MNIST patch codec, the VAE's convs (4x4 stride 2, `SAME`) and the U-Net
halves (3x3 stride 2) at the scripts' shapes.

`train_latent_only` samples 4 latents of 32x32 by 16 midpoint steps of a
dim-256 depth-8 model, about 140 s on one CPU thread; its sampling call is
made here at 8x8 (`fixed_modality_shape`), everything else as the script
makes it. On the card `chip_smoke.py` runs every twin at its own sizes."""

import importlib.util
import pathlib
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.examples import train_mnist_vae
from transfusion_tpu_torch.examples._common import MnistPatchDecoder, MnistPatchEncoder
from transfusion_tpu_torch.models.modality_io import SameConv2d, SameConvTranspose2d

torch.set_num_threads(1)

JAX_EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TRAIN = ["--device", "cpu", "--steps", "2", "--sample-every", "2", "--batch-size", "2"]
# twin -> the sampler its JAX script calls
SAMPLERS = {
    "train_toy": "sample",
    "train_text_only": "generate_text_only",
    "train_mnist": "sample",
    "train_mnist_vae": "sample",
    "train_mnist_with_unet": "sample",
    "train_image_only": "generate_modality_only",
    "train_image_only_with_unet": "generate_modality_only",
    "train_latent_only": "generate_modality_only",
    "train_latent_with_text": "sample",
}


def run_twin(name, argv, monkeypatch, tmp_path):
    # run_module executes a fresh copy of the script's module
    monkeypatch.delitem(sys.modules, f"transfusion_tpu_torch.examples.{name}", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_module(f"transfusion_tpu_torch.examples.{name}", run_name="__main__")


def last_loss(out: str) -> float:
    """The loss of the last '<step>: <loss>' (or '<step>: train <loss> ...')
    line."""
    lines = [ln.split(":", 1)[1].split() for ln in out.splitlines()
             if ln.split(":", 1)[0].isdigit()]
    assert lines, out[-2000:]
    words = lines[-1]
    return float(words[1] if words[0] == "train" else words[0])


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_training_twin_runs_and_samples(name, monkeypatch, tmp_path, capsys):
    method = SAMPLERS[name]
    calls, real = [], getattr(Transfusion, method)

    def counted(self, *args, **kw):
        calls.append(kw)
        if name == "train_latent_only":
            kw = dict(kw, fixed_modality_shape=(8, 8))
        return real(self, *args, **kw)

    monkeypatch.setattr(Transfusion, method, counted)
    extra = ["--ae-steps", "2"] if name == "train_mnist_vae" else []
    run_twin(name, TRAIN + extra, monkeypatch, tmp_path)
    loss = last_loss(capsys.readouterr().out)
    assert np.isfinite(loss), (name, loss)
    assert len(calls) == 1, (name, method, len(calls))


def test_serve_text_twin_runs_every_demo(monkeypatch, tmp_path, capsys):
    run_twin("serve_text", ["--device", "cpu", "--history", "32", "--tokens", "4",
                            "--batch", "2", "--dim", "64", "--depth", "2", "--kv-quantize",
                            "--multimodal", "--ragged", "--engine", "--mm-engine"],
             monkeypatch, tmp_path)
    out = capsys.readouterr().out
    for head in ("decode:", "ragged batch", "engine (", "mm-engine (", "multimodal sample()"):
        assert head in out, (head, out)
    assert "'mod'" in out.split("multimodal sample()")[1]


def test_distributed_twin_runs_under_torchrun(tmp_path):
    """The data x context twin (`train_distributed --context 2`) in 2 gloo
    processes under torchrun: exit code 0 within 120 s, and both ranks print
    the same finite first loss; and its pipeline (`--pipeline 2`), which
    raised before the pipeline slice, exits 0."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(JAX_EXAMPLES.parent), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=2", "-m",
                        "transfusion_tpu_torch.examples.train_distributed", "--device", "cpu",
                        "--context", "2", "--steps", "2"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "mesh: data=1 fsdp=1 tensor=1 context=2" in r.stdout
    firsts = [ln for ln in r.stdout.splitlines() if ln.startswith("1: ")]
    assert len(firsts) == 2 and firsts[0] == firsts[1] and np.isfinite(float(firsts[0][3:]))
    # --pipeline 2 (2 GPipe stages; test_torch_pipeline_distributed.py runs 4)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=2", "-m",
                        "transfusion_tpu_torch.examples.train_distributed", "--device", "cpu",
                        "--pipeline", "2", "--steps", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "mesh: data=1 pipe=2 microbatches=4 batch=8" in r.stdout


# ---------------------------------------------------------------------------
# the twins' modules against the JAX scripts' flax modules
# ---------------------------------------------------------------------------


def jax_script(name):
    """Import a JAX example script as a module (its main() is not run)."""
    path = sys.path[:]
    try:
        spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                      JAX_EXAMPLES / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_patch_codec_matches_flax():
    jx = jax_script("train_mnist")
    x = np.random.default_rng(0).uniform(size=(3, 28, 28)).astype(np.float32)
    z_j = jx.PatchEncoder().apply({}, jnp.asarray(x))
    z_t = MnistPatchEncoder()(torch.tensor(x))
    close(z_t, z_j)
    z = np.random.default_rng(1).uniform(-1.2, 1.2, (3, 14, 14, 4)).astype(np.float32)
    close(MnistPatchDecoder()(torch.tensor(z)), jx.PatchDecoder().apply({}, jnp.asarray(z)))


def test_vae_convs_match_flax():
    jx = jax_script("train_mnist_vae")
    x = np.random.default_rng(0).uniform(size=(3, 28, 28)).astype(np.float32)
    enc_j, dec_j = jx.Encoder(), jx.Decoder()
    pe = enc_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    z = enc_j.apply(pe, jnp.asarray(x))
    pd = dec_j.init(jax.random.PRNGKey(1), z)
    enc, dec = train_mnist_vae.Encoder(), train_mnist_vae.Decoder()
    p, q = pe["params"], pd["params"]
    enc.load_state_dict({
        **{f"conv0.{k}": v for k, v in enc.conv0.from_flax(p["Conv_0"]).items()},
        **{f"conv1.{k}": v for k, v in enc.conv1.from_flax(p["Conv_1"]).items()}})
    dec.load_state_dict({
        **{f"deconv0.{k}": v for k, v in dec.deconv0.from_flax(q["ConvTranspose_0"]).items()},
        **{f"deconv1.{k}": v for k, v in dec.deconv1.from_flax(q["ConvTranspose_1"]).items()}})
    z_t = enc(torch.tensor(x))
    assert z_t.shape == (3, 7, 7, train_mnist_vae.DIM_LATENT)
    close(z_t, z)
    # the decoder on latents away from zero, so the clip to [0, 1] is not all
    zn = np.asarray(z) * 40
    close(dec(torch.tensor(zn)), dec_j.apply(pd, jnp.asarray(zn)))


@pytest.mark.parametrize("script,hw", [("train_mnist_with_unet", 14),
                                       ("train_image_only_with_unet", 14),
                                       ("train_latent_with_text", 32)])
def test_unet_halves_match_flax(script, hw):
    jx = jax_script(script)
    x = np.random.default_rng(0).standard_normal((2, hw, hw, 4)).astype(np.float32)
    down_j, up_j = jx.Down(), jx.Up()
    pd = down_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    h = down_j.apply(pd, jnp.asarray(x))
    pu = up_j.init(jax.random.PRNGKey(1), h)
    dim = h.shape[-1]
    down, up = SameConv2d(4, dim), SameConvTranspose2d(dim, 4)
    down.load_state_dict(down.from_flax(pd["params"]))
    up.load_state_dict(up.from_flax(pu["params"]))
    h_t = down(torch.tensor(x))
    assert h_t.shape == (2, hw // 2, hw // 2, dim)
    close(h_t, h)
    close(up(torch.tensor(np.asarray(h))), up_j.apply(pu, h))
