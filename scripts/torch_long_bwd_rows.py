#!/usr/bin/env python3
"""Repeat the long-context backward hold of `chip_smoke.py` (phase 6) on
fresh captures, to see how its row rule varies from one training step to
the next.

    python3 scripts/torch_long_bwd_rows.py [N]

Builds the port's kernels, then N times (default 20): resets the 573M model
(`chip_smoke.LONG_CFG`, seed 0) to its initial weights, runs one
`Trainer(grad_accumulation=2).train_step` on the two seeded n 16384 packs
while capturing the first `flash_attention` call and its output cotangent,
and holds `flash_attention_backward` against its plain version on that call
with `chip_smoke.check_flash_bwd` (plain in 1024-row blocks). The dq
atomics upstream make each capture's cotangent differ in its last bits.
Prints the card's name and power limit, then one JSON line per capture
(max abs error, error over the gradient's largest element, max row error
over the row's RMS, and the same row rule of the kernel's rounding model
alone: `backward_plain_f32(round_operands=bf16)` against the plain
version); a capture past the row rule (0.08) also logs
`chip_smoke.diagnose_bwd_rows`'s worst rows and saves the capture under
build/. Needs one card (a few seconds a capture after a minute of
building).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from transfusion_tpu_torch import Transfusion
    from transfusion_tpu_torch.models import layers
    from transfusion_tpu_torch.ops import _build, flash_attn, spans
    from transfusion_tpu_torch.training import Trainer

    if not torch.cuda.is_available():
        print("torch_long_bwd_rows: no CUDA device", file=sys.stderr)
        return 2
    n_captures = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    mods = dict(flash=flash_attn, layers=layers, spans=spans)

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **cs.LONG_CFG)
    rng = np.random.default_rng(0)
    packs = [model.pack([cs.long_sample(rng)], shift_friendly=True).to_torch("cuda")
             for _ in range(2)]
    gen = torch.Generator("cuda").manual_seed(0)
    draws = [model.make_draws(p, gen) for p in packs]
    initial = {k: v.clone() for k, v in model.core.state_dict().items()}
    t0 = time.perf_counter()
    for i in range(n_captures):
        model.core.load_state_dict(initial)
        trainer = Trainer(model, learning_rate=3e-4, grad_accumulation=2)
        state = trainer.init_state()
        with cs.capturing(torch, mods, {"flash_fwd": lambda a: True}) as calls:
            trainer.train_step(state, packs, draws=draws)
        torch.cuda.synchronize()
        a = calls.pop("flash_fwd")
        del trainer, state, calls
        res = cs.check_flash_bwd(torch, mods, a, iters=1, block_q=cs.LONG_BLOCK_Q)
        line = {"capture": i, "err": res["err"], "rel_err": res["rel_err"],
                "row_rel_err": res["row_rel_err"],
                "rounding_row_rel_err": rounding_row_rule(torch, flash_attn, a),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del a
    return 0


def rounding_row_rule(torch, fa, a):
    """The row rule of the bf16 kernel's rounding model alone on the
    capture: `backward_plain_f32(round_operands=bf16)` (p as hi + lo, ds
    rounded before the dk / dq products) against the plain version, as
    `check_flash_bwd` holds the kernel."""
    import chip_smoke as cs

    q, k, v, sp, cap, do = a["q"], a["k"], a["v"], a["spans"], a["softcap"], a["do"]
    out, lse = fa.flash_attention(q, k, v, spans=sp, causal=a["causal"], softcap=cap,
                                  return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, sp, cap, 0, 0, cs.LONG_BLOCK_Q)
    want = fa.flash_attention_backward_plain(*args)
    rounded = [t.to(torch.bfloat16) for t in fa.backward_plain_f32(
        *args, round_operands=torch.bfloat16)]
    return cs.grad_compare(torch, rounded, want)[2]


if __name__ == "__main__":
    sys.exit(main())
