"""Find the knee of an image-serving cell (`runners/serve_image.py`): run its
traffic at several fixed rates in one process (one engine, set up and
warmed once) and print, for each rate, the latency tails and whether the
engine kept up.

    python3 portbench/sweep_image.py --workload <cell> --rates 0.5,1,2,3,4 \\
        [--seconds 30] [--seed n]

One JSON line a rate: requests due in the window and finished, p50 / p90
of the latency (due to the image on the host), images a second
received in the window, the queue's depth when the window closed and the
generator's lateness. The knee is the highest rate whose requests all
finish with no queue left at the close; a cell below it runs at 0.8 x the
knee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=2**31 + 101)
    args = p.parse_args(argv)
    common.set_cache_env()
    cell, cfg, traffic, arch, runner = common.load_cell(args.workload)
    common.require_devices(cell["chips"])

    import torch

    traffic = dict(traffic, num_text_tokens=cfg["num_text_tokens"])
    engine = runner.build_engine(arch, cell, cfg, traffic, args.seed, "cuda")
    som_id = engine.model.som_ids[0]
    runner.warm(engine, traffic, som_id)
    ramp, drain = traffic["ramp_s"], traffic["drain_s"]
    budget = runner.image_len(traffic) - 1
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        reqs = runner.requests(traffic, args.seed + i, [ramp, args.seconds, drain], som_id, rate)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w0, w1 = t0 + ramp, t0 + ramp + args.seconds
        rec = runner.drive(engine, reqs, budget, t0, w0, w1, drain, None, torch.cuda.synchronize)
        stats = runner.summarize(rec)
        depth = [t["row"]["queue_depth"] for t in rec["ticks"]
                 if t["row"] is not None and t["t1"] <= w1]
        images = sum(1 for r in rec["recs"] if r["done"] is not None and w0 <= r["done"] < w1)
        stats.update(rate=rate, images_per_s=images / args.seconds,
                     queue_at_close=depth[-1] if depth else None,
                     queue_max=max(depth) if depth else None)
        print(json.dumps(stats), flush=True)
        while engine.has_work:  # let the engine drain before the next rate
            engine.step()
    print(f"portbench: {common.power_limit()}", file=sys.stderr)


if __name__ == "__main__":
    main()
