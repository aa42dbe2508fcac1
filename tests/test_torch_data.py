"""PyTorch port: the data loaders and offline datasets (`data/dataloader.py`,
`data/datasets.py`) and the `Transfusion` accessors against the JAX
package on the CPU, exactly: the same seed gives the same batches and the
same packed batches, the same files (or fallbacks) the same arrays. The
port's `PackingLoader` also hands a worker's exception to the caller
instead of leaving `next()` waiting, and `close()` joins its thread."""

import threading

import numpy as np
import pytest
import torch

from transfusion_tpu.data import dataloader as jdl
from transfusion_tpu.data import datasets as jds
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data import dataloader as tdl
from transfusion_tpu_torch.data import datasets as tds
from transfusion_tpu_torch.models.modality_io import PatchDecoder, PatchEncoder

torch.set_num_threads(1)

CFG = dict(num_text_tokens=16, dim_latent=4, modality_default_shape=(2, 2), pad_multiple=16,
           transformer=dict(dim=32, depth=1, dim_head=16, heads=2))


def dataset(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 16, 1 + i % 4).astype(np.int32),
             rng.standard_normal((2, 2, 4)).astype(np.float32)) for i in range(n)]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        assert len(bg) == len(bw)
        for sg, sw in zip(bg, bw):
            assert isinstance(sg, list) and len(sg) == len(sw)
            for a, b in zip(sg, sw):
                np.testing.assert_array_equal(a, b)


def assert_packed_equal(got, want):
    for f in ("text", "cfg_mask", "spans", "lengths", "total_tokens"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert len(got.groups) == len(want.groups)
    for gg, gw in zip(got.groups, want.groups):
        for f in ("latents", "batch_idx", "offsets", "span_rows"):
            np.testing.assert_array_equal(getattr(gg, f), np.asarray(getattr(gw, f)))
        assert (gg.modality_type, tuple(gg.seq_shape)) == (gw.modality_type, tuple(gw.seq_shape))


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True), (True, False)])
def test_dataloader_and_cycle_match_jax(shuffle, drop_last):
    data = dataset()
    kw = dict(batch_size=3, shuffle=shuffle, seed=5, drop_last=drop_last)
    t, j = tdl.DataLoader(data, **kw), jdl.DataLoader(data, **kw)
    assert len(t) == len(j) == (3 if drop_last else 4)
    assert_batches_equal(list(t), list(j))
    # cycle: the next epochs reshuffle from the same generator state
    ct, cj = tdl.cycle(tdl.create_dataloader(data, **kw)), jdl.cycle(
        jdl.create_dataloader(data, **kw))
    assert_batches_equal([next(ct) for _ in range(10)], [next(cj) for _ in range(10)])


def test_packing_loader_matches_jax():
    jm = JaxTransfusion(**CFG)
    tm = Transfusion(device="cpu", **CFG)
    data = dataset(9)
    jl = jdl.PackingLoader(jm, data, batch_size=4, seed=3)
    tl = tdl.PackingLoader(tm, data, batch_size=4, seed=3)
    try:
        for _ in range(4):  # two epochs of two batches
            assert_packed_equal(next(tl), next(jl))
    finally:
        tl.close()
        jl.close()
    assert not tl._thread.is_alive()


def test_packing_loader_encodes_on_the_worker():
    """The frozen encoder runs on the worker thread, without a gradient; the
    packed latents are the encoded ones."""
    kw = dict(CFG, modality_encoder=PatchEncoder(), modality_decoder=PatchDecoder(),
              modality_default_shape=(2, 2))
    tm = Transfusion(device="cpu", **kw)
    imgs = np.random.default_rng(1).uniform(size=(4, 4, 4, 1)).astype(np.float32)
    data = [(np.asarray([1, 2], np.int32), img) for img in imgs]
    loader = tdl.PackingLoader(tm, data, batch_size=2, shuffle=False)
    try:
        packed = next(loader)
    finally:
        loader.close()
    want = tm.pack(tm.encode_modalities([list(d) for d in data[:2]]), shift_friendly=True)
    assert_packed_equal(packed, want)


class _Failing:
    def encode_modalities(self, batch):
        raise RuntimeError("encoder exploded")


def _next_within(loader, seconds=10.0):
    """next(loader) on a thread; (raised exception | None, finished?)."""
    out = {}

    def call():
        try:
            next(loader)
        except BaseException as e:
            out["exc"] = e

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(seconds)
    return out.get("exc"), not th.is_alive()


def test_packing_loader_worker_error_reaches_the_caller():
    loader = tdl.PackingLoader(_Failing(), dataset(4), batch_size=2)
    try:
        exc, finished = _next_within(loader)
    finally:
        loader.close()
    assert finished, "next() blocked on a dead worker"
    assert isinstance(exc, RuntimeError) and "encoder exploded" in str(exc.__cause__)
    assert not loader._thread.is_alive()

    small = tdl.PackingLoader(Transfusion(device="cpu", **CFG), dataset(2), batch_size=4)
    try:
        exc, finished = _next_within(small)
    finally:
        small.close()
    assert finished and isinstance(exc.__cause__, ValueError), exc


def test_packing_loader_close_joins_a_blocked_worker():
    tm = Transfusion(device="cpu", **CFG)
    loader = tdl.PackingLoader(tm, dataset(12), batch_size=2, prefetch=1)
    next(loader)  # the worker now waits on a full queue
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


def test_offline_datasets_match_jax(tmp_path, monkeypatch):
    """The fallbacks (no data directory), then the same files read by both."""
    for mod in (jds, tds):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path / "absent")
    np.testing.assert_array_equal(tds.load_enwik8(n_bytes=50_000),
                                  jds.load_enwik8(n_bytes=50_000))
    for got, want in zip(tds.load_mnist(n=64), jds.load_mnist(n=64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = tds.load_flowers_latents(n=6, hw=8), jds.load_flowers_latents(n=6, hw=8)
    assert got.shape == (6, 8, 8, 4)
    np.testing.assert_array_equal(got, want)
    assert tds.load_flowers_labels() == jds.load_flowers_labels()

    rng = np.random.default_rng(0)
    (tmp_path / "enwik8").write_bytes(rng.integers(0, 256, 3000).astype(np.uint8).tobytes())
    np.savez(tmp_path / "mnist.npz", x_train=rng.integers(0, 256, (20, 28, 28)).astype(np.uint8),
             y_train=rng.integers(0, 10, 20).astype(np.uint8))
    for mod in (jds, tds):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path)
    np.testing.assert_array_equal(tds.load_enwik8(n_bytes=1000), jds.load_enwik8(n_bytes=1000))
    for got, want in zip(tds.load_mnist(n=8), jds.load_mnist(n=8)):
        np.testing.assert_array_equal(got, want)
    (tmp_path / "flowers").mkdir()
    (tmp_path / "flowers" / "labels.txt").write_text("rose\n\n tulip \n")
    assert tds.load_flowers_labels() == ["rose", "tulip"]


@pytest.mark.parametrize("channel_first", [False, True])
def test_modality_accessors_and_create_dataloader_match_jax(channel_first):
    kw = dict(CFG, channel_first_latent=channel_first)
    jm, tm = JaxTransfusion(**kw), Transfusion(device="cpu", **kw)
    for got, want in zip(tm.get_all_modality_info(), jm.get_all_modality_info()):
        assert got.keys() == want.keys()
        for k in got:
            if k == "to_shape_fn":  # each package's own default
                assert got[k]("3,5") == want[k]("3,5") == (3, 5)
            elif k not in ("encoder", "decoder"):
                assert got[k] == want[k], k
        assert got["encoder"] is None and want["encoder"] is None
    assert tm.get_modality_info() == tm.get_modality_info(0)
    x = np.zeros((4, 3, 5) if channel_first else (3, 5, 4), np.float32)
    assert tm.get_modality_shape(x) == jm.get_modality_shape(x) == (3, 5)
    assert tm.get_modality_shape(torch.tensor(x)) == (3, 5)
    data = dataset()
    assert_batches_equal(list(tm.create_dataloader(data, batch_size=2, shuffle=True, seed=1)),
                         list(jm.create_dataloader(data, batch_size=2, shuffle=True, seed=1)))

    enc = Transfusion(device="cpu", modality_encoder=PatchEncoder(), **CFG).get_modality_info()
    assert isinstance(enc["encoder"], PatchEncoder) and not enc["encoder"].training
    assert not any(p.requires_grad for p in enc["encoder"].parameters())
