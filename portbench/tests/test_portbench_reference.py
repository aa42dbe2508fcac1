"""The plain reference against the port's CPU path at a tiny size, the
comparison that decides `correct` against the faults a cell can have, and
the control (the reference in fp8) against the limits.

The tiny runs drive the benchmark's own runners, generators and reference
on the CPU (the look for a card skipped); the port's attention there is its
plain path. A `cuda`-marked test reads the control at a cell's own size on
the card (`portbench/control.py` does the same for the limits' readings).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import common, run
from portbench.reference import quant, serve_check, train_check
from portbench.tests import tiny

ARCH = common.architecture(tiny.CFG)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_blocked_attention_matches_one_block():
    """The reference's attention in query blocks, each over the keys its
    rows can see, equals one softmax over every key with the mask."""
    from portbench.reference import model

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 1100, 8, generator=g, dtype=torch.float64) for _ in range(3))
    spans = torch.tensor([[[0, 500, 30], [0, 1020, 70], [0, 0, 0]],
                          [[0, 3, 600], [0, 0, 0], [0, 0, 0]]])
    rows = torch.arange(1100)
    whole = model._attend_block(q, k, v, model.allowed_mask(rows, rows, spans))
    torch.testing.assert_close(model.attention(q, k, v, spans), whole, rtol=1e-12, atol=1e-12)


def run_tiny(cell, seed=2**31 + 5, seconds=0.2):
    return run.run_cell("tiny", seed, seconds, False, device="cpu", cell_override=cell)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_reference_agrees_with_the_port(microbatches):
    result, checks = run_tiny(tiny.train_cell(microbatches))
    assert result["correct"], checks
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_gap"]["value"] < 1e-4


def test_serve_reference_agrees_with_the_port():
    result, checks = run_tiny(tiny.serve_cell(), seconds=1.5)
    assert result["correct"], checks
    assert result["attempted"] >= 3 and result["failed"] == 0
    assert checks["logit_gap"]["value"] < 1e-4


def test_fault_state_unchanged(monkeypatch):
    from transfusion_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def unchanged(self, state, batch, draws=None, generator=None):
        return state, step(self, state, batch, draws=draws)[1]

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    result, checks = run_tiny(tiny.train_cell())
    assert not result["correct"]
    assert checks["update_gap"]["value"] > 0.99


def test_fault_half_the_batch(monkeypatch):
    from transfusion_tpu_torch import Transfusion

    pack = Transfusion.pack

    def half(self, samples, **kw):
        return pack(self, samples[:max(1, len(samples) // 2)], **kw)

    monkeypatch.setattr(Transfusion, "pack", half)
    result, checks = run_tiny(tiny.train_cell())
    assert not result["correct"], checks


def test_fault_token_altered(monkeypatch):
    from transfusion_tpu_torch.models import sample_batch

    fetch = sample_batch._fetch

    def altered(payload):
        out = np.array(fetch(payload))
        out[:, 0] = (out[:, 0] + 1) % tiny.CFG["num_text_tokens"]
        return out

    monkeypatch.setattr(sample_batch, "_fetch", altered)
    result, checks = run_tiny(tiny.serve_cell(), seconds=1.5)
    assert not result["correct"], checks


def _train_inputs(cell, seed):
    got = {}

    def after(step_rows, step_draws, program, names):
        got.update(rows=step_rows, draws=step_draws, program=program, names=names)

    from portbench.runners import train

    train.run(ARCH, cell["cell"], cell["cfg"], cell["traffic"], seed, 0.1, False, device="cpu",
              check=False, after=after)
    return got


def test_control_fails_the_tiny_limits():
    """The reference in fp8, put in the program's place, reads past a limit
    the program keeps (training), and past the serving limit."""
    cell = tiny.train_cell()
    seed = 31
    got = _train_inputs(cell, seed)
    args = (ARCH, cell["cfg"], seed, "cpu", got["rows"], got["draws"],
            cell["traffic"]["row_len"] + 1, got["names"], 3e-4)
    ref = train_check.follow(*args)
    program = train_check.compare(got["program"], ref, got["names"])
    control = train_check.compare(train_check.follow(*args, quant=quant.fp8), ref, got["names"])
    limits = cell["cell"]["limits"]
    assert all(program[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits), control

    rng = np.random.default_rng(0)
    sample = [(rng.integers(0, 200, 12), rng.integers(0, 200, 6).tolist()) for _ in range(3)]
    gap = serve_check.widest_gap(ARCH, tiny.CFG, seed, "cpu", sample, quant=quant.fp8)
    assert gap > tiny.serve_cell()["cell"]["limits"]["logit_gap"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at a cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["t037-train-4k"])
def test_control_fails_on_the_card(card, name):
    cell, cfg, traffic, arch, runner = common.load_cell(name)
    out = runner.readings(arch, cell, cfg, traffic, 2**31 + 77, 0.5, True)
    assert all(out["program"][k] <= v for k, v in cell["limits"].items()), out
    assert any(out["control"][k] > v for k, v in cell["limits"].items()), out
    assert any(out["half"][k] > v for k, v in cell["limits"].items()), out
