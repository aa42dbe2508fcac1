"""The block-bound arithmetic against values recorded before it moved behind
`architectures/transfusion.py`: the weight spec, the weights of the tiny
configuration, the work counts and what each work-counting reader reads, for
both Transfusion configurations and the tiny one. Each must come out equal,
so that the move changed no reading."""

from __future__ import annotations

import hashlib
import json

import pytest

from portbench import common, weights, work
from portbench.generators.train_packed import image_head, row_layout, step_rows
from portbench.tests import tiny

CFGS = {"transfusion-0.37b": common.load_json("configs", "transfusion-0.37b.json"),
        "transfusion-1.4b": common.load_json("configs", "transfusion-1.4b.json"),
        "tiny": dict(tiny.CFG)}
ARCH = common.architecture(tiny.CFG)

# the serving work of a few ticks: three prompts admitted, decoded in chunks
TICKS = [{"work": {"admitted": [512, 37], "decoded": [(512, 0, 1), (37, 0, 1)]}},
         {"work": {"admitted": [2048],
                   "decoded": [(512, 1, 65), (37, 1, 65), (2048, 0, 64)]}},
         {"work": {"admitted": [], "decoded": [(512, 65, 128), (2048, 64, 100)]}}]
INF = float("inf")
# peaks that make a roofline share read 100 x its FLOPs, or 100 x its bytes, over 1 s
FLOPS = {"bf16_flops_per_s": 1.0, "hbm_bytes_per_s": INF}
BYTES = {"bf16_flops_per_s": INF, "hbm_bytes_per_s": 1.0}
KERNEL = {"flash_fwd.roofline.train": "flash_fwd_tc",
          "flash_bwd.roofline.train": "flash_bwd_dq",
          "flash_fwd.roofline.serve": "flash_fwd_tc",
          "decode_attn.roofline.serve": "decode_mma"}

# the 4k and 16k steps' work (their seed-0 row layouts), and the ticks' work
STEP_WORK = {"4k": {"positions": 32768, "text": 27904, "image_rows": 4864, "images": 19,
                    "pairs": 67745408, "rows": 8},
             "16k": {"positions": 32768, "text": 30976, "image_rows": 1792, "images": 7,
                     "pairs": 268680320, "rows": 2}}
SERVE_WORK = {"prompts": 3, "prefill_tokens": 2597, "prefill_pairs": 2230207, "decoded": 293,
              "decode_kv": 288192}

# recorded with the parent of the move: sha256 of the spec as JSON, its leaves and numel,
# the vocabulary, the forward and attention FLOPs of the 4k and 16k steps, the weights
# a text position multiplies by
GOLDEN = {
    "transfusion-0.37b": {
        "spec_sha256": "721683d3cc034c4b8c3db85b97b57361b7585c85730d80e2410aef10e51d8825",
        "spec_len": 547, "numel": 1002339152, "vocab_size": 32134,
        "forward_flops": {"4k": 30007488569344.0, "16k": 49947364876288.0},
        "attention_flops": {"4k": 6659644588032.0, "16k": 26412350177280.0},
        "model_step_params": 327876608,
    },
    "transfusion-1.4b": {
        "spec_sha256": "bcaea14c987780004242892635d979dce596b43643c17953fb9eeb6bff35f31b",
        "spec_len": 547, "numel": 3875386720, "vocab_size": 32134,
        "forward_flops": {"4k": 102945373077504.0, "16k": 142795933335552.0},
        "attention_flops": {"4k": 13319289176064.0,
                            "16k": 52824700354560.0},
        "model_step_params": 1310113792,
    },
    "tiny": {
        "spec_sha256": "e8c9af31f82d992308b2e1d26c9eaa111458ab6a03848c30d48672e7541ea1e9",
        "spec_len": 97, "numel": 671606, "vocab_size": 334,
        "forward_flops": {"4k": 84573595136.0, "16k": 290446151168.0},
        "attention_flops": {"4k": 69371297792.0, "16k": 275128647680.0},
        "model_step_params": 213376,
    },
}
# what each reader reads on the works above with the peaks above (a kernel of 1 s)
READINGS = {
    "transfusion-0.37b": {
        "flash_fwd.roofline.train|4k|remat=False|flops": 665964458803200.0,
        "flash_fwd.roofline.train|4k|remat=False|bytes": 649278259200.0,
        "flash_fwd.roofline.train|4k|remat=True|flops": 1331928917606400.0,
        "flash_fwd.roofline.train|4k|remat=True|bytes": 1298556518400.0,
        "flash_bwd.roofline.train|4k|remat=False|flops": 1664911147008000.0,
        "flash_bwd.roofline.train|4k|remat=False|bytes": 1293523353600.0,
        "flash_bwd.roofline.train|4k|remat=True|flops": 1664911147008000.0,
        "flash_bwd.roofline.train|4k|remat=True|bytes": 1293523353600.0,
        "train_mfu|4k": 9002246570803200.0,
        "flash_fwd.roofline.train|16k|remat=False|flops": 2641235017728000.0,
        "flash_fwd.roofline.train|16k|remat=False|bytes": 649278259200.0,
        "flash_fwd.roofline.train|16k|remat=True|flops": 5282470035456000.0,
        "flash_fwd.roofline.train|16k|remat=True|bytes": 1298556518400.0,
        "flash_bwd.roofline.train|16k|remat=False|flops": 6603087544320000.0,
        "flash_bwd.roofline.train|16k|remat=False|bytes": 1293523353600.0,
        "flash_bwd.roofline.train|16k|remat=True|flops": 6603087544320000.0,
        "flash_bwd.roofline.train|16k|remat=True|bytes": 1293523353600.0,
        "train_mfu|16k": 1.49842094628864e+16,
        "flash_fwd.roofline.serve|flops": 21923826892800.0,
        "flash_fwd.roofline.serve|bytes": 51059097600.0,
        "decode_attn.roofline.serve|flops": 2833042636800.0,
        "decode_attn.roofline.serve|bytes": 2833042636800.0,
        "serve_mfu": 216217537740800.0,
    },
    "transfusion-1.4b": {
        "flash_fwd.roofline.train|4k|remat=False|flops": 1331928917606400.0,
        "flash_fwd.roofline.train|4k|remat=False|bytes": 1293523353600.0,
        "flash_fwd.roofline.train|4k|remat=True|flops": 2663857835212800.0,
        "flash_fwd.roofline.train|4k|remat=True|bytes": 2587046707200.0,
        "flash_bwd.roofline.train|4k|remat=False|flops": 3329822294016000.0,
        "flash_bwd.roofline.train|4k|remat=False|bytes": 2582013542400.0,
        "flash_bwd.roofline.train|4k|remat=True|flops": 3329822294016000.0,
        "flash_bwd.roofline.train|4k|remat=True|bytes": 2582013542400.0,
        "train_mfu|4k": 3.08836119232512e+16,
        "flash_fwd.roofline.train|16k|remat=False|flops": 5282470035456000.0,
        "flash_fwd.roofline.train|16k|remat=False|bytes": 1293523353600.0,
        "flash_fwd.roofline.train|16k|remat=True|flops": 1.0564940070912e+16,
        "flash_fwd.roofline.train|16k|remat=True|bytes": 2587046707200.0,
        "flash_bwd.roofline.train|16k|remat=False|flops": 1.320617508864e+16,
        "flash_bwd.roofline.train|16k|remat=False|bytes": 2582013542400.0,
        "flash_bwd.roofline.train|16k|remat=True|flops": 1.320617508864e+16,
        "flash_bwd.roofline.train|16k|remat=True|bytes": 2582013542400.0,
        "train_mfu|16k": 4.28387800006656e+16,
        "flash_fwd.roofline.serve|flops": 43847653785600.0,
        "flash_fwd.roofline.serve|bytes": 102118195200.0,
        "decode_attn.roofline.serve|flops": 5666085273600.0,
        "decode_attn.roofline.serve|bytes": 5666085273600.0,
        "serve_mfu": 810655488409600.0,
    },
    "tiny": {
        "flash_fwd.roofline.train|4k|remat=False|flops": 6937129779200.0,
        "flash_fwd.roofline.train|4k|remat=False|bytes": 6815744000.0,
        "flash_fwd.roofline.train|4k|remat=True|flops": 13874259558400.0,
        "flash_fwd.roofline.train|4k|remat=True|bytes": 13631488000.0,
        "flash_bwd.roofline.train|4k|remat=False|flops": 17342824448000.0,
        "flash_bwd.roofline.train|4k|remat=False|bytes": 13526630400.0,
        "flash_bwd.roofline.train|4k|remat=True|flops": 17342824448000.0,
        "flash_bwd.roofline.train|4k|remat=True|bytes": 13526630400.0,
        "train_mfu|4k": 25372078540800.0,
        "flash_fwd.roofline.train|16k|remat=False|flops": 27512864768000.0,
        "flash_fwd.roofline.train|16k|remat=False|bytes": 6815744000.0,
        "flash_fwd.roofline.train|16k|remat=True|flops": 55025729536000.0,
        "flash_fwd.roofline.train|16k|remat=True|bytes": 13631488000.0,
        "flash_bwd.roofline.train|16k|remat=False|flops": 68782161920000.0,
        "flash_bwd.roofline.train|16k|remat=False|bytes": 13526630400.0,
        "flash_bwd.roofline.train|16k|remat=True|flops": 68782161920000.0,
        "flash_bwd.roofline.train|16k|remat=True|bytes": 13526630400.0,
        "train_mfu|16k": 87133845350400.0,
        "flash_fwd.roofline.serve|flops": 228373196800.0,
        "flash_fwd.roofline.serve|bytes": 531865600.0,
        "decode_attn.roofline.serve|flops": 29510860800.0,
        "decode_attn.roofline.serve|bytes": 29510860800.0,
        "serve_mfu": 382480844800.0,
    },
}
TINY_WEIGHTS_SHA256 = {
    0: "b558730d8d51f5edf9a3c8d4d28b8501c088365d3fd3a0fc716e3c615cb091cc",
    1: "801b3e2b4f1a477ca53c3a9748a45bbc96a6fa3118c3a7c72f238fe79b9fbc9e",
    2: "20394a4e6c47b3888806b2f78cee08561a515c8784d4f16f6b71aff2076112dd",
}


def step_work(mix: str) -> dict:
    traffic = common.load_json("traffic", f"{mix}.json")
    layouts = [row_layout(traffic, 0, i) for i in step_rows(traffic, 0)]
    L = traffic["image_shape"][0] * traffic["image_shape"][1]
    return work.train_step_work({"n": traffic["row_len"], "layouts": layouts, "image_len": L,
                                 "image_head": image_head(traffic["image_shape"])})


def readings(cfg: dict, arch=ARCH) -> dict:
    """What the work-counting readers read of STEP_WORK and TICKS."""
    out = {}
    for wname, w in STEP_WORK.items():
        for name in ("flash_fwd.roofline.train", "flash_bwd.roofline.train"):
            for remat in (False, True):
                for pk, tag in ((FLOPS, "flops"), (BYTES, "bytes")):
                    ctx = {"arch": arch, "cfg": cfg, "peaks": pk, "traced_work": [w],
                           "remat": remat, "device_ops": [(KERNEL[name], 0.0, 1.0)]}
                    out[f"{name}|{wname}|remat={remat}|{tag}"] = common.load_reader(
                        name).read(ctx)
        ctx = {"arch": arch, "cfg": cfg, "peaks": FLOPS, "outside_work": [w], "outside_s": 1.0}
        out[f"train_mfu|{wname}"] = common.load_reader("train_mfu").read(ctx)
    for name in ("flash_fwd.roofline.serve", "decode_attn.roofline.serve"):
        for pk, tag in ((FLOPS, "flops"), (BYTES, "bytes")):
            ctx = {"arch": arch, "cfg": cfg, "peaks": pk, "traced_ticks": TICKS,
                   "device_ops": [(KERNEL[name], 0.0, 1.0)]}
            out[f"{name}|{tag}"] = common.load_reader(name).read(ctx)
    ctx = {"arch": arch, "cfg": cfg, "peaks": FLOPS, "outside_ticks": TICKS, "outside_s": 1.0}
    out["serve_mfu"] = common.load_reader("serve_mfu").read(ctx)
    return out


def test_work_dicts_unchanged():
    assert {k: step_work(m) for k, m in (("4k", "pretrain-4k"), ("16k", "context-16k"))} == (
        STEP_WORK)
    assert work.serve_work(TICKS) == SERVE_WORK


@pytest.mark.parametrize("name", list(CFGS))
def test_spec_unchanged(name):
    cfg, want = CFGS[name], GOLDEN[name]
    spec = ARCH.spec(cfg)
    assert hashlib.sha256(json.dumps(spec).encode()).hexdigest() == want["spec_sha256"]
    assert len(spec) == want["spec_len"]
    assert sum(weights.numel(s) for _, s, _ in spec) == want["numel"]
    assert ARCH.vocab_size(cfg) == want["vocab_size"]


@pytest.mark.parametrize("name", list(CFGS))
def test_work_counts_unchanged(name):
    cfg, want = CFGS[name], GOLDEN[name]
    assert {k: ARCH.forward_flops(cfg, w) for k, w in STEP_WORK.items()} == want["forward_flops"]
    assert {k: work.attention_flops(ARCH.attention_pair(cfg), w["pairs"])
            for k, w in STEP_WORK.items()} == want["attention_flops"]
    assert ARCH.model_step_params(cfg) == want["model_step_params"]


@pytest.mark.parametrize("name", list(CFGS))
def test_reader_counts_unchanged(name):
    assert readings(CFGS[name]) == READINGS[name]


@pytest.mark.parametrize("seed", list(TINY_WEIGHTS_SHA256))
def test_tiny_weights_unchanged(seed):
    W = weights.make(ARCH, tiny.CFG, seed, "cpu")
    h = hashlib.sha256()
    for name in sorted(W):
        h.update(name.encode())
        h.update(W[name].contiguous().numpy().tobytes())
    assert h.hexdigest() == TINY_WEIGHTS_SHA256[seed]
