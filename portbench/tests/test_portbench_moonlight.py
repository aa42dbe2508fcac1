"""The Moonlight architecture (`architectures/moonlight.py`) by hand: its
parameter count, work and attention widths; its refusal of a
configuration that hides the cut; the four readers of the expert layers and
the image cell on synthetic contexts; and the tiny Moonlight and image
cells on the CPU through `run.run_cell`, with the faults that their new
checks must catch."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import common, run, weights
from portbench.runners import serve_image, train_experts
from portbench.tests import tiny, tiny_moonlight

CFG = common.load_json("configs", "moonlight-16b-a3b.json")
ARCH = common.architecture(CFG)
SEED = 2**31 + 23


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_spec_counts_one_expert_parallel_share():
    """27 layers at d 2048: MLA's projections and norms, layer 0's dense
    SwiGLU of 11,264, 26 expert layers of a 64-way router, its bias, 2
    shared and 8 held experts of 1408; an eighth of the vocabulary plus the
    port's 134 ids for the embedding and the head; the time embedding, its
    input map and the latent projections."""
    d = 2048
    mla = 16 * 192 * d + 576 * d + 512 + 16 * 256 * 512 + d * 16 * 128 + 2 * d
    expert = 3 * d * 1408
    moe = 64 * d + 64 + 2 * expert + 8 * expert
    vocab = 2 * (20480 + 134) * d
    time = 4 * d * (d + 1) + 4 * d + d * 4 * d + d + d // 2
    latent = d * 32 + d + 32 * d
    want = 27 * mla + 3 * d * 11264 + 26 * moe + vocab + time + latent + d
    got = sum(weights.numel(s) for _, s, _ in ARCH.spec(CFG))
    assert got == want == 2_811_668_608
    assert round(26 * (mla + moe) / 1e6, 1) == 2610.6  # 26 x 100.4M


def test_work_of_the_block():
    assert ARCH.attention_pair(CFG) == (27 * 16 * 192, 27 * 16 * 128)
    assert ARCH.flash_position_bytes(CFG) == {"q": 2 * 82944, "k": 2 * 82944, "v": 2 * 55296,
                                              "o": 2 * 55296, "lse": 4 * 16 * 27}
    d, mi = 2048, 1408
    per_pos = (27 * (16 * 192 * d + 576 * d + 16 * 256 * 512 + d * 16 * 128)
               + 3 * d * 11264 + 26 * (64 * d + (2 + 6 * 8 / 64) * 3 * d * mi))
    assert ARCH.model_step_params(CFG) == per_pos
    w = {"positions": 32768, "text": 30000, "image_rows": 2560, "images": 10, "pairs": 10**8,
         "rows": 8}
    want = (2.0 * per_pos * 32768 + 2.0 * 20614 * d * 30000 + 2.0 * 2 * 32 * d * 2560
            + 2.0 * 10 * ((d + 1) * 4 * d + 4 * d * d) + 2.0 * (82944 + 55296) * 10**8)
    assert ARCH.forward_flops(CFG, w) == want
    flops, nbytes = ARCH.expert_flops_and_bytes(CFG, 1000, 4)
    assert flops == 4 * 2.0 * 3 * d * mi * 1000
    assert nbytes == 4 * 2.0 * (26 * 8 * 3 * d * mi + 1000 * (2 * d + 3 * mi))


@pytest.mark.parametrize("fault", ["reduced", "published", "source", "vocab"])
def test_check_config_refuses_a_hidden_cut(fault):
    cfg = copy.deepcopy(CFG)
    if fault == "reduced":
        cfg["reduced"] = ["vocab_size"]
    elif fault == "published":
        del cfg["published"]["n_routed_experts"]
    elif fault == "source":
        cfg["source"] = "https://example.org/config.json"
    else:
        cfg["num_text_tokens"] = 163840
    with pytest.raises((ValueError, KeyError)):
        ARCH.check_config(cfg)


def ctx_with(**kw):
    base = {"arch": ARCH, "cfg": CFG, "remat": True, "traced_work": [{}, {}],
            "peaks": {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12},
            "device_ops": [], "host_ops": [], "trace_lo": 0.0, "trace_hi": 1.0}
    base.update(kw)
    return base


def test_expert_readers_on_synthetic_contexts():
    roof = common.load_reader("moe_expert.roofline.train")
    counts = [[3000] * 8 for _ in range(26)]
    A = 26 * 8 * 3000
    flops, nbytes = ARCH.expert_flops_and_bytes(CFG, A, 4)
    ops = [("void cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>", 0.0, 0.5),
           ("elementwise_kernel", 0.5, 0.9)]
    got = roof.read(ctx_with(moe_traced_counts=counts, device_ops=ops))
    assert got == pytest.approx(100.0 * max(flops / 989e12, nbytes / 3.35e12) / 0.5)
    assert roof.read(ctx_with()) is None  # a program without the counter

    load = common.load_reader("moe_load_max.train")
    assert load.read(ctx_with(moe_window_counts=[[1, 1, 1, 5], [2, 2, 2, 2]])) == 1.75
    assert load.read(ctx_with()) is None

    idle = common.load_reader("idle_moe_ms.train")
    host = [("transfusion.moe.route", 0.1, 0.2), ("transfusion.moe.experts", 0.2, 0.4),
            ("transfusion.train.step", 0.0, 1.0)]
    dev = [("k", 0.15, 0.3)]
    # inside the spans 0.1-0.4, the card busy 0.15-0.3: 0.15 s idle over 2 steps
    assert idle.read(ctx_with(host_ops=host, device_ops=dev)) == pytest.approx(75.0)
    assert idle.read(ctx_with()) is None

    ode = common.load_reader("ode_group.image")
    assert ode.read({"ode_images": 30.0, "ode_dispatches": 4}) == 7.5
    assert ode.read({"ode_images": 0.0, "ode_dispatches": 0}) is None


def run_tiny(cell, seconds=0.3, trace=False, runner_kw=None):
    if runner_kw:
        arch = common.architecture(cell["cfg"])
        return None, train_experts.run(arch, cell["cell"], cell["cfg"], cell["traffic"], SEED,
                                       seconds, trace, device="cpu", **runner_kw)[1]
    return run.run_cell("tiny", SEED, seconds, trace, device="cpu", cell_override=cell)


def test_tiny_moonlight_cell_runs_and_checks():
    result, checks = run_tiny(tiny_moonlight.train_cell())
    print(checks)
    assert result["correct"], checks
    assert set(checks) == {"loss_gap", "grad_gap", "update_gap", "route_gap", "load_gap"}
    assert checks["route_gap"]["value"] == 0.0 and checks["load_gap"]["value"] == 0.0
    result, _ = run_tiny(tiny_moonlight.train_cell(), trace=True)
    assert result["device"]["platform"] == "cpu"


def test_tiny_moonlight_cell_catches_the_bias_ignored():
    """Routers that choose by their scores alone fail route_gap."""
    _, checks = run_tiny(tiny_moonlight.train_cell(), runner_kw={"bias_ignored": True})
    print(checks)
    assert checks["route_gap"]["value"] > checks["route_gap"]["limit"]


def image_cell() -> dict:
    traffic = copy.deepcopy(common.load_json("traffic", "image.json"))
    traffic.update(rate=3.0, caption={"min": 3, "max": 12}, image_shape=[4, 4], ramp_s=0.5,
                   sample=3)
    cell = {"config": "tiny", "traffic": "tiny", "chips": 1,
            "engine": {"max_requests": 4, "max_seq_len": 64, "cfg_scale": 3.0,
                       "modality_steps": 4},
            "limits": {"image_gap": 1e-4}}
    return {"cell": cell, "cfg": dict(tiny.CFG), "traffic": traffic}


def test_tiny_image_cell_runs_checks_and_catches_an_altered_latent(monkeypatch):
    result, checks = run_tiny(image_cell(), seconds=1.5)
    print(checks)
    assert result["correct"], checks
    assert result["attempted"] >= 3 and checks["unfinished"]["value"] == 0
    sample_requests = serve_image.sample_requests

    def altered(rec, seed, k):
        return [dict(r, latent=serve_image.image_check.altered(r["latent"]))
                for r in sample_requests(rec, seed, k)]

    monkeypatch.setattr(serve_image, "sample_requests", altered)
    cell = image_cell()
    _, checks = serve_image.run(common.architecture(cell["cfg"]), cell["cell"], cell["cfg"],
                                cell["traffic"], SEED, 1.5, False, device="cpu")
    assert checks["image_gap"]["value"] > 0.1


def test_image_traffic_lays_out_captions_ending_in_som():
    traffic = dict(common.load_json("traffic", "image.json"), num_text_tokens=100, rate=2.0)
    reqs = serve_image.requests(traffic, SEED, [1.0, 5.0, 2.0], som_id=103)
    assert [sum(1 for r in reqs if r[2] == s) for s in range(3)] == [2, 10, 4]
    for due, prompt, _ in reqs:
        assert prompt[-1] == 103 and 16 <= len(prompt) - 1 <= 128
        assert (prompt[:-1] < 100).all()
    again = serve_image.requests(traffic, SEED, [1.0, 5.0, 2.0], som_id=103)
    assert all((a[1] == b[1]).all() and a[0] == b[0] for a, b in zip(reqs, again))
