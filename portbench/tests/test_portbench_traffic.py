"""The traffic generators: the same seed gives the same traffic, another
seed other traffic, and the shapes the cells promise."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import common
from portbench.generators import serve_open_loop
from portbench.generators.train_packed import Rows, image_cost, row_layout

SEEDS = (7, 2**31 + 11)


def _row_positions(traffic, layout):
    return 2 + sum(it[1] if it[0] == "t" else image_cost(traffic) for it in layout)


def _same_row(r1, r2) -> bool:
    """Two samples hold the same items (text ids and latents)."""
    def arrays(row):
        return [it[1] if isinstance(it, tuple) else it for it in row]

    return len(r1) == len(r2) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(arrays(r1), arrays(r2)))


@pytest.mark.parametrize("mix", ["pretrain-4k", "context-16k"])
def test_train_rows_repeat_and_differ(mix):
    traffic = common.load_json("traffic", f"{mix}.json")
    a = Rows(traffic, SEEDS[0], 32000, 32)
    b = Rows(traffic, SEEDS[0], 32000, 32)
    c = Rows(traffic, SEEDS[1], 32000, 32)
    for i in (0, 5):
        assert _same_row(a[i], b[i])
        assert not _same_row(a[i], c[i])
    assert not _same_row(a[0], a[1])


@pytest.mark.parametrize("mix", ["pretrain-4k", "context-16k"])
def test_train_rows_fill_exactly(mix):
    traffic = common.load_json("traffic", f"{mix}.json")
    for seed in SEEDS:
        for i in range(6):
            layout = row_layout(traffic, seed, i)
            assert _row_positions(traffic, layout) == traffic["row_len"]
            assert all(it[1] > 0 for it in layout if it[0] == "t")


def test_train_rows_mix_text_and_images():
    traffic = common.load_json("traffic", "pretrain-4k.json")
    images = sum(it[0] == "i" for i in range(40) for it in row_layout(traffic, 3, i))
    assert 80 <= images <= 400  # half the documents are caption-image pairs


def test_serve_requests_repeat_and_permute():
    traffic = common.load_json("traffic", "chat.json")
    stretches = [10.0, 51.0, 20.0]
    a = serve_open_loop.requests(traffic, SEEDS[0], stretches, 32000)
    b = serve_open_loop.requests(traffic, SEEDS[0], stretches, 32000)
    c = serve_open_loop.requests(traffic, SEEDS[1], stretches, 32000)
    for (da, pa, ba, sa), (db, pb, bb, sb) in zip(a, b):
        assert (da, ba, sa) == (db, bb, sb)
        np.testing.assert_array_equal(pa, pb)
    for k, length in enumerate(stretches):
        ra = [r for r in a if r[3] == k]
        rc = [r for r in c if r[3] == k]
        assert len(ra) == len(rc) == round(traffic["rate"] * length)
        # the same work due in each stretch, in another order
        assert sorted(len(r[1]) for r in ra) == sorted(len(r[1]) for r in rc)
        assert sorted(r[2] for r in ra) == sorted(r[2] for r in rc)
        lo = sum(stretches[:k])
        assert all(lo <= r[0] < lo + length for r in ra)
    assert [len(r[1]) for r in a] != [len(r[1]) for r in c]
    for _, p, budget, _ in a:
        assert traffic["prompt"]["min"] <= len(p) <= traffic["prompt"]["max"]
        assert traffic["output"]["min"] <= budget <= traffic["output"]["max"]
        assert p[0] == 32000 and (p[1:] < 32000).all()
    due = [r[0] for r in a]
    assert due == sorted(due) and due[0] == 0.0
