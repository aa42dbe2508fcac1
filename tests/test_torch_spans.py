"""PyTorch port: the program's spans (`training.metrics.span`) on the CPU.

With no profiler running a span is one shared no-op. Under
`torch.profiler.profile` the trainer's step, the packing loader's wait and
the serving engine's tick record their `transfusion.*` ranges, nested and
in order, on the calling thread."""

import numpy as np
import pytest
import torch

from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.data.dataloader import PackingLoader
from transfusion_tpu_torch.models.engine import ServingEngine
from transfusion_tpu_torch.training import Trainer
from transfusion_tpu_torch.training.metrics import span

torch.set_num_threads(1)

CFG = dict(num_text_tokens=16, dim_latent=4, modality_default_shape=(2, 2), pad_multiple=16,
           transformer=dict(dim=32, depth=1, dim_head=16, heads=2))


def samples(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 16, 2 + i % 3).astype(np.int32),
             (0, rng.standard_normal((2, 2, 4)).astype(np.float32))] for i in range(n)]


def spans_of(prof) -> list:
    """[(name, start_ns, end_ns)] of the profile's transfusion.* ranges on
    the host, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("transfusion.")
           and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda x: x[1])


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans_of(prof)


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_the_shared_noop_without_a_profiler():
    a, b = span("transfusion.test.a"), span("transfusion.test.b", "args")
    assert a is b
    assert not isinstance(a, torch.profiler.record_function)
    with a as got:
        assert got is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("transfusion.test.c"), torch.profiler.record_function)
    assert span("transfusion.test.d") is a


@pytest.mark.parametrize("accum", [None, 2])
def test_trainer_step_records_its_layers_in_order(accum):
    torch.manual_seed(0)
    model = Transfusion(device="cpu", **CFG)
    trainer = Trainer(model, grad_accumulation=accum)
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(0)
    (state, _), got = profiled(lambda: trainer.train_step(state, samples(), generator=gen))
    names = [n for n, _, _ in got]
    micro = accum or 1
    assert names.count("transfusion.train.step") == 1
    step = got[names.index("transfusion.train.step")]
    for n in names:
        assert n.startswith("transfusion.train.")
    for s in got:
        assert inside(s, step), s
    inner = [n for n in names if n != "transfusion.train.step"]
    want = (["transfusion.train.batch", "transfusion.train.draws"]
            + ["transfusion.train.forward", "transfusion.train.backward"] * micro)
    if micro > 1:
        want.insert(6, "transfusion.train.reduce")  # the accumulation's sum
    assert inner == want + ["transfusion.train.update"]
    assert len(got) <= 8 + 3 * (micro - 1)


def test_trainer_log_span_with_metrics_path(tmp_path):
    torch.manual_seed(0)
    model = Transfusion(device="cpu", **CFG)
    trainer = Trainer(model, metrics_path=str(tmp_path / "m.jsonl"))
    state = trainer.init_state()
    _, got = profiled(lambda: trainer.train_step(state, samples(),
                                                 generator=torch.Generator().manual_seed(0)))
    assert [n for n, _, _ in got][-2:] == ["transfusion.train.update", "transfusion.train.log"]
    assert inside(got[-1], got[0])


def test_packing_loader_next_records_its_wait():
    model = Transfusion(device="cpu", **CFG)
    loader = PackingLoader(model, [s for s in samples(6)], batch_size=2, shuffle=False)
    try:
        packed, got = profiled(lambda: next(loader))
    finally:
        loader.close()
    assert packed.text.shape[0] == 2
    assert [n for n, _, _ in got] == ["transfusion.loader.next"]


def test_engine_tick_records_admit_prefill_then_the_chunk():
    torch.manual_seed(0)
    model = Transfusion(device="cpu", num_text_tokens=8, dim_latent=16,
                        modality_default_shape=(4,), pad_multiple=16,
                        transformer=dict(dim=32, depth=1, dim_head=32, heads=1))
    eng = ServingEngine(model, max_batch=2, max_seq_len=256, decode_chunk=4)
    for p in ([8, 1, 2], [8, 3]):
        eng.submit(np.asarray(p, np.int32), 3)
    done, got = profiled(eng.run)
    assert len(done) == 2
    names = [n for n, _, _ in got]
    ticks = [s for s in got if s[0] == "transfusion.engine.tick"]
    assert ticks
    first = [s for s in got if inside(s, ticks[0]) and s is not ticks[0]]
    assert [n for n, _, _ in first] == [
        "transfusion.engine.admit", "transfusion.engine.prefill", "transfusion.engine.plan",
        "transfusion.engine.decode", "transfusion.engine.fetch", "transfusion.engine.retire"]
    assert inside(first[1], first[0])  # the prefill inside the admission
    assert all(a[2] <= b[1] for a, b in zip(first[1:], first[2:]))  # one after another
    # one prefill group: the two prompts share a width bucket
    assert names.count("transfusion.engine.prefill") == 1
    for t in ticks:
        assert len([s for s in got if inside(s, t)]) <= 1 + 6 + 1
