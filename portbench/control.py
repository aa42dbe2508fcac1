"""The readings that set a cell's limits (not part of the benchmark's own
runs): the program's numbers on many seeds, the control's (the plain
reference in fp8, the precision below the configurations' bf16, put in
the program's place) and, for training, the planted fault of half the
batch left out, each against the float32 reference, at the cell's own
size on the card.

    python3 portbench/control.py --workload <cell> --seeds <s1,s2,...>
        [--control-seeds <s1,s2,s3>] [--seconds <s>]

One line of JSON a seed on standard output; the program's readings on
every seed, the control's and the fault's on the control seeds, as the
cell's runner gives them (its `readings`). Training runs set up and run one
short window a seed; serving runs a short window at the cell's load and
reads the same sample as a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    common.set_cache_env()
    cell, cfg, traffic, arch, runner = common.load_cell(args.workload)
    common.require_devices(cell["chips"])
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + sorted(control - set(seeds)):
        print(json.dumps(runner.readings(arch, cell, cfg, traffic, seed, args.seconds,
                                         seed in control)), flush=True)


if __name__ == "__main__":
    main()
