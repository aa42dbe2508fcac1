"""The yardstick's FLOP and byte counts (`work.py` and the architecture's)
against hand counts at tiny shapes."""

from __future__ import annotations

import torch

from portbench import common, work
from portbench.generators.train_packed import image_head
from portbench.reference.model import allowed_mask
from portbench.tests import tiny

ARCH = common.architecture(tiny.CFG)


def test_visible_pairs_match_the_mask():
    n = 40
    spans = [(3, 6), (20, 9)]
    sp = torch.tensor([[[0, o, L] for o, L in spans] + [[0, 0, 0]]])
    rows = torch.arange(n)
    mask = allowed_mask(rows, rows, sp)
    assert int(mask.sum()) == work.visible_pairs(n, spans)


def test_row_spans_follow_the_packed_layout():
    # [sos] 5 text [meta 1,1 som] 1 row [eom] 2 text [eos]
    layout = [("t", 5), ("i",), ("t", 2)]
    head = image_head((1, 1))
    assert head == 5
    assert work.row_spans(layout, 1, head) == [(1 + 5 + head, 1)]


def test_step_work_hand_count():
    step = {"n": 16, "image_len": 4, "image_head": 5,
            "layouts": [[("t", 3), ("i",)], [("t", 14)]]}
    w = work.train_step_work(step)
    # row 0: image rows at 1 + 3 + 5 = 9..12; 16 * 17 / 2 + 4 * 3 / 2 pairs
    assert w == {"positions": 32, "text": 28, "image_rows": 4, "images": 1,
                 "pairs": 136 + 6 + 136, "rows": 2}


def test_forward_flops_hand_count():
    cfg = dict(tiny.CFG, num_hidden_layers=2, hidden_size=4, num_attention_heads=2, head_dim=2,
               ff_expansion_factor=1.5, num_text_tokens=6, dim_latent=3)
    # inner 4, ff inner int(4 * 1.5 * 2 / 3) = 4
    # block 0: qk 2*4*4 + v 16 + out 16 + gates 8 + ff 2*4*4 + 4*4 = 120
    # block 1: + mix 8 + skip 2*4*4 = 160
    assert ARCH.block_matmul_params(cfg, 0) == 120
    assert ARCH.block_matmul_params(cfg, 1) == 160
    w = {"positions": 10, "text": 7, "image_rows": 3, "images": 1, "pairs": 20}
    V = 6 + 134
    expect = (2 * 280 * 10 + 2 * V * 4 * 7 + 2 * 2 * 3 * 4 * 3
              + 2 * 1 * (5 * 16 + 2 * 2 * 12 * 16) + 4 * 4 * 20 * 2)
    assert ARCH.forward_flops(cfg, w) == expect


def _ctx(device_ops):
    return {"device_ops": device_ops, "arch": ARCH, "cfg": dict(tiny.CFG),
            "peaks": {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}}


def test_train_rooflines_hand_count():
    ctx = _ctx([("void tc::flash_fwd_tc<32>(Args)", 0.0, 2.0),
                ("flash_bwd_dkv_tc<32>", 2.0, 6.0), ("row_ends", 6.0, 7.0),
                ("elementwise_kernel", 7.0, 9.0)])
    w = {"positions": 100, "pairs": 1000}
    ctx.update(traced_work=[w], remat=False)
    cfg = ctx["cfg"]
    inner, depth = 64, 4
    f_fwd = 4 * inner * 1000 * depth
    b_fwd = depth * 100 * (4 * inner * 2 + 2 * 4)
    share = 100 * max(f_fwd / 1e12, b_fwd / 1e9) / 2.0
    assert abs(common.load_reader("flash_fwd.roofline.train").read(ctx) - share) < 1e-9
    f_bwd, b_bwd = 2.5 * f_fwd, depth * 100 * (8 * inner * 2 + 2 * 4)
    share = 100 * max(f_bwd / 1e12, b_bwd / 1e9) / 5.0
    assert abs(common.load_reader("flash_bwd.roofline.train").read(ctx) - share) < 1e-9
    assert cfg["num_attention_heads"] * cfg["head_dim"] == inner


def test_serve_rooflines_hand_count():
    ticks = [{"work": {"admitted": [3], "decoded": [(3, 0, 2)]}}]
    w = work.serve_work(ticks)
    assert w == {"prompts": 1, "prefill_tokens": 3, "prefill_pairs": 6, "decoded": 2,
                 "decode_kv": 4 + 5}
    ctx = _ctx([("decode_mma", 0.0, 1.0), ("decode_merge", 1.0, 1.5),
                ("flash_fwd_tc", 2.0, 2.25)])
    ctx["traced_ticks"] = ticks
    inner, depth = 64, 4
    dec = 100 * max(4 * inner * depth * 9 / 1e12, 4 * inner * depth * 9 / 1e9) / 1.5
    assert abs(common.load_reader("decode_attn.roofline.serve").read(ctx) - dec) < 1e-9
    pre = 100 * max(4 * inner * depth * 6 / 1e12, depth * 3 * 4 * inner * 2 / 1e9) / 0.25
    assert abs(common.load_reader("flash_fwd.roofline.serve").read(ctx) - pre) < 1e-9


def test_reader_finds_nothing_returns_none():
    ctx = _ctx([("elementwise_kernel", 0.0, 1.0)])
    ctx.update(traced_work=[{"positions": 1, "pairs": 1}], remat=False,
               traced_ticks=[{"work": {"admitted": [3], "decoded": [(3, 0, 1)]}}])
    for name in ("flash_fwd.roofline.train", "flash_bwd.roofline.train",
                 "decode_attn.roofline.serve", "flash_fwd.roofline.serve"):
        assert common.load_reader(name).read(ctx) is None


def test_union_and_idle():
    iv = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)]
    assert common.union_seconds(iv, 0.0, 10.0) == 4.0
    ctx = {"busy_s": 4.0, "trace_window_s": 10.0}
    assert abs(common.load_reader("device_idle.train").read(ctx) - 60.0) < 1e-12
    bd = common.breakdown(iv, [("aten::mm", 3.0, 5.0)], 0.0, 6.0)
    assert bd["device_ops"][0] == ["a", 2.0] and bd["idle_gaps"] == [["aten::mm", 2.0]]
