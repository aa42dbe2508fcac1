"""A new architecture or traffic kind comes to the benchmark as new files.

An architecture module and two runners in another directory hand every
hook on to `architectures/transfusion.py` and the training and serving
runners, and log each call. The tiny cells, driven through
`run.run_cell` from that directory, call every hook and print the checks
of the plain run; an unknown architecture or runner fails naming the file
it looked for; `"architecture": "transfusion"` written out is the default.
"""

from __future__ import annotations

import copy
from pathlib import Path

import pytest
import torch

from portbench import common, run
from portbench.tests import tiny
from portbench.tests.test_portbench_golden import readings

SEED = 2**31 + 19

SPY_ARCH = '''
import types
from pathlib import Path

from portbench import common

LOG = Path(__file__).resolve().parent.parent / "calls.log"
transfusion = common.architecture({})


def _spy(name, fn):
    def call(*args, **kwargs):
        with open(LOG, "a") as f:
            f.write(name + "\\n")
        return fn(*args, **kwargs)
    return call


for _name in common.HOOKS:
    if _name != "reference":
        globals()[_name] = _spy(_name, getattr(transfusion, _name))
reference = types.SimpleNamespace(**{
    n: _spy("reference." + n, getattr(transfusion.reference, n))
    for n in ("joint_loss", "text_logits")})
'''

SPY_RUNNER = '''
from pathlib import Path

from portbench.runners import {real} as real

LOG = Path(__file__).resolve().parent.parent / "calls.log"


def run(*args, **kwargs):
    with open(LOG, "a") as f:
        f.write("runner.{real}\\n")
    return real.run(*args, **kwargs)


readings = real.readings
'''


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def spy_root(tmp_path):
    (tmp_path / "architectures").mkdir()
    (tmp_path / "runners").mkdir()
    (tmp_path / "architectures" / "spy.py").write_text(SPY_ARCH)
    for real in ("train", "serve"):
        (tmp_path / "runners" / f"spy_{real}.py").write_text(SPY_RUNNER.format(real=real))
    return tmp_path


def calls(root: Path) -> set:
    log = root / "calls.log"
    return set(log.read_text().split()) if log.exists() else set()


def spied(cell: dict) -> dict:
    cell = copy.deepcopy(cell)
    cell["cfg"]["architecture"] = "spy"
    cell["traffic"]["runner"] = "spy_" + {"train_packed": "train",
                                         "serve_open_loop": "serve"}[cell["traffic"]["kind"]]
    return cell


def run_tiny(cell: dict, seconds: float, root=common.ROOT):
    return run.run_cell("tiny", SEED, seconds, False, device="cpu", cell_override=cell,
                        root=root)


def test_new_files_call_every_hook(spy_root):
    train, serve = tiny.train_cell(), tiny.serve_cell()
    plain = {"train": run_tiny(train, 0.2), "serve": run_tiny(serve, 1.5)}
    got = {"train": run_tiny(spied(train), 0.2, spy_root),
           "serve": run_tiny(spied(serve), 1.5, spy_root)}
    for kind in ("train", "serve"):
        (result, checks), (want_result, want_checks) = got[kind], plain[kind]
        assert result["correct"] and want_result["correct"], (checks, want_checks)
        assert checks == want_checks, kind
    ran = calls(spy_root)
    assert {"runner.train", "runner.serve"} <= ran
    assert {"reference.joint_loss", "reference.text_logits"} <= ran

    spy = common.architecture({"architecture": "spy"}, spy_root)
    assert readings(dict(tiny.CFG, architecture="spy"), spy) == readings(
        dict(tiny.CFG), common.architecture(tiny.CFG))
    spy.check_config(common.load_json("configs", "transfusion-1.4b.json"))
    ran = calls(spy_root)
    assert set(common.HOOKS) - {"reference"} <= ran, sorted(set(common.HOOKS) - ran)


def test_architecture_written_out_is_the_default():
    cell = tiny.train_cell()
    named = copy.deepcopy(cell)
    named["cfg"]["architecture"] = "transfusion"
    assert run_tiny(named, 0.2)[1] == run_tiny(cell, 0.2)[1]


@pytest.mark.parametrize("what", ["architecture", "runner", "kind"])
def test_unknown_name_names_the_file(spy_root, what):
    cell = spied(tiny.train_cell())
    if what == "architecture":
        cell["cfg"]["architecture"] = "absent"
        path = spy_root / "architectures" / "absent.py"
    elif what == "runner":
        cell["traffic"]["runner"] = "absent"
        path = spy_root / "runners" / "absent.py"
    else:
        del cell["traffic"]["runner"]
        cell["traffic"]["kind"] = "absent"
        path = spy_root / "runners"
    with pytest.raises(SystemExit, match=str(path)):
        run_tiny(cell, 0.2, spy_root)


def test_hooks_missing_are_named(spy_root):
    (spy_root / "architectures" / "partial.py").write_text("def spec(cfg):\n    return []\n")
    with pytest.raises(SystemExit, match="lacks.*build_model"):
        common.architecture({"architecture": "partial"}, spy_root)
