"""The benchmark's manifest and files: every cell, configuration, traffic
mix, architecture, runner and per-layer metric that BENCHMARK.json names
loads by name, and the manifest keeps to the benchmark contract's
shapes."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import common

MANIFEST = json.loads((common.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [m["name"] for m in MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        kind_names = [m["name"] for m in MANIFEST[kind]]
        assert len(kind_names) == len(set(kind_names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


def test_run_seconds_fit_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_file_loads(entry):
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = common.load_json("configs", f"{entry['name']}.json")
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert len(cfg["source"]) <= 200
    common.architecture(cfg).check_config(cfg)


@pytest.mark.parametrize("entry", MANIFEST["workloads"], ids=lambda e: e["name"])
def test_cell_files_load(entry):
    cell, cfg, traffic, _, runner = common.load_cell(entry["name"])
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert cfg["name"] == entry["config"]
    assert Path(runner.__file__).is_file() and callable(runner.run)
    assert len(entry["why"]) <= 200
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("entry", MANIFEST["per_layer"], ids=lambda e: e["name"])
def test_metric_readers_load(entry):
    reader = common.load_reader(entry["name"])
    assert callable(reader.read)
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert entry["moves"] in e2e
    assert set(entry["workloads"]) <= cells


def test_every_cell_reports_enough():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in MANIFEST["per_layer"])


def test_one_layer_one_name():
    """Metrics of one layer give the same layer name, and PERF.md's list of
    layers holds each."""
    perf = (common.CHECKOUT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MANIFEST["per_layer"]}:
        assert f"| {layer} |" in perf
