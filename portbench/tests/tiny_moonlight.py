"""A tiny configuration of the Moonlight block (`architectures/moonlight.py`)
and its training cell, for runs on the CPU in the tests: d 64, one dense
and two expert layers, 16 routed experts of which 8 are held, top 4, q k
24 + 8 RoPE dims beside values of 16."""

from __future__ import annotations

import copy

from portbench import common
from portbench.architectures.moonlight import SOURCE

CFG = {
    "name": "tiny-moonlight", "architecture": "moonlight", "source": SOURCE,
    "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 2, "kv_lora_rank": 32,
    "qk_nope_head_dim": 24, "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
    "moe_intermediate_size": 32, "n_routed_experts": 8, "num_experts_per_tok": 4,
    "n_shared_experts": 2, "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
    "rms_norm_eps": 1e-5, "rope_theta": 50000, "vocab_size": 200, "num_text_tokens": 200,
    "dim_latent": 8, "latent_shape": [4, 4], "dtype": "float32", "attn_impl": "flash",
    "reduced": ["n_routed_experts", "vocab_size"],
    "published": {"n_routed_experts": 16, "vocab_size": 1600},
}


def train_cell(microbatches: int = 1, remat: bool = True) -> dict:
    traffic = copy.deepcopy(common.load_json("traffic", "pretrain-4k-experts.json"))
    traffic.update(rows_per_step=2 * microbatches, row_len=128, microbatches=microbatches,
                   image_shape=[4, 4], text_doc={"median": 30, "sigma": 1.0, "min": 4,
                                                 "max": 128})
    cell = {"config": "tiny-moonlight", "traffic": "tiny", "chips": 1,
            "trainer": {"learning_rate": 3e-4}, "model": {"remat": remat},
            "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2,
                       "route_gap": 1e-3, "load_gap": 1e-3}}
    return {"cell": cell, "cfg": copy.deepcopy(CFG), "traffic": traffic}
