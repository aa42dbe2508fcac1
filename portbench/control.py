"""The readings that set a cell's limits (not part of the benchmark's own
runs): the program's numbers on many seeds, the control's (the plain
reference in fp8, the precision below the configurations' bf16, put in
the program's place) and, for training, the planted fault of half the
batch left out, each against the float32 reference, at the cell's own
size on the card.

    python3 portbench/control.py --workload <cell> --seeds <s1,s2,...>
        [--control-seeds <s1,s2,s3>] [--seconds <s>]

One line of JSON a seed on standard output; the program's readings on
every seed, the control's and the fault's on the control seeds. Training
runs set up and run one short window a seed; serving runs a short window
at the cell's load and reads the same sample as a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common  # noqa: E402


def train_readings(cell, cfg, traffic, seed, seconds, with_control):
    import torch

    from portbench.reference import quant, train_check
    from portbench.runners import train

    out = {"seed": seed}

    def after(step_rows, step_draws, program, names):
        n, lr = traffic["row_len"] + 1, cell.get("trainer", {}).get("learning_rate", 3e-4)
        args = (cfg, seed, "cuda", step_rows, step_draws, n, names, lr)
        ref = train_check.follow(*args)
        out["program"] = train_check.compare(program, ref, names)
        out["loss"] = {"program": program["loss"], "reference": ref["loss"]}
        if with_control:
            gc.collect()
            torch.cuda.empty_cache()
            out["control"] = train_check.compare(train_check.follow(*args, quant=quant.fp8),
                                                 ref, names)
            gc.collect()
            torch.cuda.empty_cache()
            out["half"] = train_check.compare(train_check.follow(*args, half=True), ref, names)
            out["unchanged"] = train_check.compare(
                {"loss": ref["loss"], "grad": {k: 0.0 for k in names},
                 "change": {k: 0.0 for k in names}}, ref, names)

    train.run(cell, cfg, traffic, seed, seconds, False, check=False, after=after)
    return out


def serve_readings(cell, cfg, traffic, seed, seconds, with_control):
    from portbench.reference import quant, serve_check
    from portbench.runners import serve

    out = {"seed": seed}

    def after(sample):
        out["served_tokens"] = sum(len(t) for _, t in sample)
        out["program"] = {"logit_gap": serve_check.widest_gap(cfg, seed, "cuda", sample)}
        if with_control:
            out["control"] = {"logit_gap": serve_check.widest_gap(cfg, seed, "cuda", sample,
                                                                  quant=quant.fp8)}

    serve.run(cell, cfg, traffic, seed, seconds, False, check=False, after=after)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    common.set_cache_env()
    cell, cfg, traffic = common.load_cell(args.workload)
    common.require_devices(cell["chips"])
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    fn = train_readings if traffic["kind"] == "train_packed" else serve_readings
    for seed in seeds + sorted(control - set(seeds)):
        print(json.dumps(fn(cell, cfg, traffic, seed, args.seconds, seed in control)),
              flush=True)


if __name__ == "__main__":
    main()
