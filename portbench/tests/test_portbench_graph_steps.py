"""The reader of the serving engine's `graph_steps` tick-row field against
hand counts, and its silence where no decode step ran or the rows lack the
field."""

from __future__ import annotations

import pytest

from portbench import common


def read(ctx: dict):
    return common.load_reader("graph_step_pct.serve").read(ctx)


def tick(row):
    return {"t0": 0.0, "t1": 1.0, "work": {"admitted": [], "decoded": []}, "row": row}


def ctx_of(rows) -> dict:
    return {"outside_ticks": [tick(r) for r in rows] + [tick(None)],
            "traced_ticks": [tick({"chunk_k": 8, "graph_steps": 0})]}


@pytest.mark.parametrize("rows,want", [
    ([{"chunk_k": 4, "graph_steps": 4}, {"chunk_k": 16, "graph_steps": 16}], 100.0),
    ([{"chunk_k": 4, "graph_steps": 0}, {"chunk_k": 12, "graph_steps": 12}], 75.0),
    ([{"chunk_k": 6, "graph_steps": 0}], 0.0),
])
def test_graph_step_pct_against_hand_counts(rows, want):
    assert read(ctx_of(rows)) == pytest.approx(want)


@pytest.mark.parametrize("rows", [
    [],  # no decode step ran outside the profiled ticks
    [{"chunk_k": 4, "chunk_seconds": 0.1}, {"chunk_k": 2, "chunk_seconds": 0.05}],  # no field
], ids=["no steps", "program without the field"])
def test_graph_step_pct_silent(rows):
    assert read(ctx_of(rows)) is None


def test_graph_step_pct_entry():
    manifest = {m["name"]: m for m in common.load_json("..", "BENCHMARK.json")["per_layer"]}
    entry = manifest["graph_step_pct.serve"]
    assert (entry["layer"], entry["moves"], entry["better"], entry["source"], entry["unit"]) == (
        "model step", "latency_p90_s", "higher", "program_counter", "%")
    assert entry["workloads"] == ["t14b-serve-chat"]
