"""The readers of the program's spans and tick-row fields against hand
counts on hand-built traces and tick rows, and their silence on a program
that has neither."""

from __future__ import annotations

import pytest

from portbench import common, spans


def read(metric: str, ctx: dict):
    return common.load_reader(metric).read(ctx)


def train_ctx(host_ops) -> dict:
    # the card busy over [0, 1) and [2, 4) of a [0, 5) window: idle [1, 2) and [4, 5)
    return {"device_ops": [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k3", 2.5, 4.0)],
            "host_ops": host_ops, "trace_lo": 0.0, "trace_hi": 5.0,
            "traced_work": [None, None]}


def test_merged_and_overlap():
    got = spans.merged([("a", 3, 4), ("b", 0, 2), ("c", 1, 1.5), ("d", 2, 2.5), ("e", 9, 12)],
                       0, 10)
    assert got == [[0, 2.5], [3, 4], [9, 10]]
    assert spans.overlap(got, [[1, 3.5], [9.5, 20]]) == pytest.approx(1.5 + 0.5 + 0.5)
    assert spans.overlap(got, []) == 0.0


def test_idle_inside_the_trainer_and_the_loader():
    ctx = train_ctx([
        ("transfusion.train.step", 0.5, 3.5),  # idle [1, 2): 1.0 s
        ("transfusion.train.forward", 0.6, 1.5),  # another span: not counted
        ("transfusion.loader.next", 3.6, 4.5),  # idle [4, 4.5): 0.5 s
        ("transfusion.train.step", 4.8, 6.0),  # clipped to the window: idle 0.2 s
        ("aten::mm", 1.0, 2.0),
    ])
    assert read("idle_trainer_ms.train", ctx) == pytest.approx(1e3 * 1.2 / 2)
    assert read("idle_loader_ms.train", ctx) == pytest.approx(1e3 * 0.5 / 2)
    assert spans.idle_inside(ctx, "transfusion.train.forward") == pytest.approx(0.5)


def test_idle_inside_counts_an_overlapping_span_once():
    ctx = train_ctx([("transfusion.loader.next", 0.5, 1.5), ("transfusion.loader.next", 1.2, 2.5)])
    assert spans.idle_inside(ctx, "transfusion.loader.next") == pytest.approx(1.0)


def tick(row):
    return {"t0": 0.0, "t1": 1.0, "work": {"admitted": [], "decoded": []}, "row": row}


ROWS = [
    {"chunk_k": 4, "chunk_seconds": 0.17, "dispatch_seconds": 0.12, "fetch_seconds": 0.04,
     "admitted": 2, "admit_seconds": 0.05, "queued_seconds": 0.3, "prompt_tokens": 300,
     "prefill_positions": 512},
    {"chunk_k": 6, "chunk_seconds": 0.21, "dispatch_seconds": 0.18, "fetch_seconds": 0.02,
     "admitted": 0, "admit_seconds": 0.0, "queued_seconds": 0.0, "prompt_tokens": 0,
     "prefill_positions": 0},
    {"chunk_k": 2, "chunk_seconds": 0.09, "dispatch_seconds": 0.06, "fetch_seconds": 0.02,
     "admitted": 1, "admit_seconds": 0.01, "queued_seconds": 0.9, "prompt_tokens": 100,
     "prefill_positions": 128},
]


def serve_ctx(rows) -> dict:
    return {"outside_ticks": [tick(r) for r in rows] + [tick(None)],
            "traced_ticks": [tick({"chunk_k": 4}), tick({"chunk_k": 6})],
            # decode spans [0, 0.3) and [0.5, 0.9); the card busy [0.1, 0.2) and [0.6, 1)
            "device_ops": [("k", 0.1, 0.2), ("k", 0.6, 1.0)],
            "host_ops": [("transfusion.engine.decode", 0.0, 0.3),
                         ("transfusion.engine.decode", 0.5, 0.9),
                         ("transfusion.engine.fetch", 0.3, 0.5)],
            "trace_lo": 0.0, "trace_hi": 1.0}


def test_serving_readers_against_hand_sums():
    ctx = serve_ctx(ROWS)
    assert read("dispatch_ms.serve", ctx) == pytest.approx(1e3 * 0.36 / 12)
    assert read("fetch_wait_ms.serve", ctx) == pytest.approx(1e3 * 0.08 / 12)
    assert read("admit_host_ms.serve", ctx) == pytest.approx(1e3 * 0.06 / 3)
    assert read("queue_wait_ms.serve", ctx) == pytest.approx(1e3 * 1.2 / 3)
    assert read("prefill_pad_pct.serve", ctx) == pytest.approx(100 * (1 - 400 / 640))
    # idle inside decode: [0, 0.1) + [0.2, 0.3) + [0.5, 0.6) over 10 traced steps
    assert read("idle_dispatch_ms.serve", ctx) == pytest.approx(1e3 * 0.3 / 10)
    # dispatch and fetch split the chunk's time the decode-step reader reads
    split = read("dispatch_ms.serve", ctx) + read("fetch_wait_ms.serve", ctx)
    assert split <= read("decode_step_ms.serve", ctx)


NEW = ("idle_trainer_ms.train", "idle_loader_ms.train", "dispatch_ms.serve",
       "fetch_wait_ms.serve", "idle_dispatch_ms.serve", "admit_host_ms.serve",
       "queue_wait_ms.serve", "prefill_pad_pct.serve")


@pytest.mark.parametrize("metric", NEW)
def test_silent_on_a_program_without_spans_or_fields(metric):
    """A program older than the spans: tick rows with the first fields
    only, and no transfusion.* range in the trace."""
    old = [{k: r[k] for k in ("chunk_k", "chunk_seconds", "admitted")} for r in ROWS]
    ctx = dict(serve_ctx(old), host_ops=[("portbench.engine_step", 0.0, 1.0)])
    ctx.update({k: v for k, v in train_ctx([("portbench.train_step", 0.0, 5.0)]).items()
                if k not in ctx})
    assert read(metric, ctx) is None


@pytest.mark.parametrize("metric", NEW)
def test_new_entries_name_accepted_cells(metric):
    manifest = {m["name"]: m for m in common.load_json("..", "BENCHMARK.json")["per_layer"]}
    entry = manifest[metric]
    train = metric.endswith(".train")
    assert entry["workloads"] == (["t037-train-4k", "t037-train-16k"] if train
                                  else ["t14b-serve-chat"])
    assert entry["moves"] == ("train_tokens_per_s" if train else "latency_p90_s")
