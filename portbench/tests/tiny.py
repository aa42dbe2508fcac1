"""Tiny configurations of the benchmark's cells, for runs on the CPU in the
tests: the same runners, generators and reference at sizes a test can
hold."""

from __future__ import annotations

import copy

from portbench import common

CFG = {
    "name": "tiny", "num_hidden_layers": 4, "hidden_size": 64, "num_attention_heads": 2,
    "head_dim": 32, "ff_expansion_factor": 4.0, "num_text_tokens": 200, "dim_latent": 8,
    "latent_shape": [4, 4], "dtype": "float32", "attn_impl": "flash",
}


def train_cell(microbatches: int = 1) -> dict:
    traffic = copy.deepcopy(common.load_json("traffic", "pretrain-4k.json"))
    traffic.update(rows_per_step=2 * microbatches, row_len=128, microbatches=microbatches,
                   image_shape=[4, 4], text_doc={"median": 30, "sigma": 1.0, "min": 4,
                                                 "max": 128})
    cell = {"config": "tiny", "traffic": "tiny", "chips": 1,
            "trainer": {"learning_rate": 3e-4},
            "model": {"remat": microbatches > 1},
            "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2}}
    return {"cell": cell, "cfg": dict(CFG), "traffic": traffic}


def serve_cell() -> dict:
    traffic = copy.deepcopy(common.load_json("traffic", "chat.json"))
    traffic.update(rate=4.0, prompt={"median": 12, "sigma": 1.0, "min": 2, "max": 40},
                   output={"median": 6, "sigma": 0.8, "min": 2, "max": 12}, ramp_s=0.5,
                   sample=3)
    cell = {"config": "tiny", "traffic": "tiny", "chips": 1,
            "engine": {"max_batch": 4, "max_seq_len": 64, "decode_chunk": 4},
            "limits": {"logit_gap": 1e-3}}
    return {"cell": cell, "cfg": dict(CFG), "traffic": traffic}
