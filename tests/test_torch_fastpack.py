"""PyTorch port: the native batch packer (`transfusion_tpu_torch/csrc/
fastpack.cpp`, built with the host C++ compiler at first use and loaded
with ctypes) against the port's numpy path and the JAX package's
`pack_samples(use_native=False)`, on the CPU.

The buffers of both paths are equal byte for byte (dtype, shape and
values) over wrap / meta frame / pad_len / shift_friendly and two modality
types; the latent groups are the numpy path's either way. A build that
fails (no compiler, or a compiler that exits non-zero) makes
`pack_samples(use_native=True)` raise, with no fallback; two processes that
build into one empty directory at once both load a whole library."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from transfusion_tpu.data import packing as jpack
from transfusion_tpu_torch.data import packing as tpack
from transfusion_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUFFERS = ("text", "cfg_mask", "spans", "lengths", "total_tokens")


def spec(mod):
    image = mod.ModalityPackSpec(dim_latent=4, som_id=11, eom_id=12)
    audio = mod.ModalityPackSpec(dim_latent=3, channel_first=True, num_dim=1, som_id=15,
                                 eom_id=16, seq_shape_fn=lambda s: (s[0] * 2,))
    return mod.PackSpec(num_text_tokens=8, sos_id=8, eos_id=9, null_text_id=10, meta_id=13,
                        char_offset=17, modalities=(image, audio))


def samples(seed=0):
    rng = np.random.default_rng(seed)

    def ids(n):
        return rng.integers(0, 8, n).astype(np.int32)

    return [
        [ids(3), rng.standard_normal((2, 3, 4)).astype(np.float32), ids(1)],
        [ids(1), (1, rng.standard_normal((3, 5)).astype(np.float32)),
         (0, rng.standard_normal((5, 4)).astype(np.float32)), np.zeros(0, np.int32)],
        [ids(7)],
        [(0, rng.standard_normal((1, 1, 4)).astype(np.float32)),
         (1, rng.standard_normal((3, 2)).astype(np.float32)), ids(2),
         (0, rng.standard_normal((2, 2, 4)).astype(np.float32))],
        [np.int32(5)],
    ]


def assert_same_bytes(got, want, what):
    for f in BUFFERS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f, g.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), (what, f)
    assert len(got.groups) == len(want.groups)
    for gg, gw in zip(got.groups, want.groups):
        assert (gg.modality_type, gg.latent_shape, gg.seq_shape) == (
            gw.modality_type, gw.latent_shape, gw.seq_shape)
        for f in ("latents", "batch_idx", "offsets", "span_rows"):
            np.testing.assert_array_equal(getattr(gg, f), np.asarray(getattr(gw, f)))


@pytest.mark.parametrize("wrap,meta,pad_len,shift", [
    (True, True, None, False), (True, True, None, True), (False, False, None, False),
    (True, False, 64, True), (False, True, 48, False)])
def test_native_packer_equals_numpy_and_jax(wrap, meta, pad_len, shift):
    kw = dict(wrap_sos_eos=wrap, add_meta=meta, pad_multiple=16, pad_len=pad_len,
              shift_friendly=shift)
    native = tpack.pack_samples(samples(), spec(tpack), use_native=True, **kw)
    numpy_path = tpack.pack_samples(samples(), spec(tpack), use_native=False, **kw)
    jax_path = jpack.pack_samples(samples(), spec(jpack), use_native=False, **kw)
    assert_same_bytes(native, numpy_path, "native vs numpy")
    assert_same_bytes(native, jax_path, "native vs JAX")
    assert native.spans.shape[1] == 4 and native.lengths.max() <= native.text.shape[1] - shift


def test_native_packer_is_the_default(monkeypatch):
    calls = []
    native = tpack._assemble_native

    def spy(*args):
        calls.append(len(args[0]))
        return native(*args)

    monkeypatch.setattr(tpack, "_assemble_native", spy)
    tpack.pack_samples(samples(), spec(tpack))
    tpack.pack_samples(samples(), spec(tpack), use_native=False)
    assert calls == [5]


@pytest.mark.parametrize("compiler", ["missing", "false"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """No compiler, and a compiler that exits 1: pack_samples raises with
    what the build said, and nothing is left loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "CXX", str(tmp_path / "no-such-c++") if compiler == "missing"
                        else "false")
    with pytest.raises(RuntimeError, match="did not start" if compiler == "missing"
                       else "fastpack.cpp failed"):
        tpack.pack_samples(samples(), spec(tpack), use_native=True)
    assert not _build._libs
    assert not list((tmp_path / "build").glob("*.so"))


BUILD_AND_PACK = """
import sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from tests.test_torch_fastpack import samples, spec
from transfusion_tpu_torch.data import packing
from transfusion_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
Path(sys.argv[3]).touch()
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.01)
got = packing.pack_samples(samples(), spec(packing), use_native=True)
want = packing.pack_samples(samples(), spec(packing), use_native=False)
for f in ("text", "cfg_mask", "spans", "lengths"):
    assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
print("built", _build._paths("fastpack")[0].name)
"""


def test_concurrent_builds_both_load(tmp_path):
    """Two processes build into one empty directory at the same moment:
    each writes its own temporary file and renames it into place, and both
    pack with a whole library."""
    build, go = tmp_path / "build", tmp_path / "go"
    ready = [tmp_path / f"ready{i}" for i in range(2)]
    script = BUILD_AND_PACK.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(build), str(go), str(r)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in ready]
    try:
        deadline = time.monotonic() + 120
        while not all(r.exists() for r in ready) and time.monotonic() < deadline:
            time.sleep(0.01)
        go.touch()  # both imported: they start building together
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "built fastpack-" in out
    assert [p.name for p in build.glob("*.so")] == [_build._paths("fastpack")[0].name]
    assert not list(build.glob("*.tmp*"))
