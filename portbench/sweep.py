"""Find the knee of a serving cell: run its traffic at several fixed rates
in one process (one engine, set up and warmed once) and print, for each
rate, the tails and whether the engine kept up.

    python3 portbench/sweep.py --workload <cell> --rates 1,2,3,4,5,6 \\
        [--seconds 30] [--seed n]

One JSON line a rate: requests due in the window and finished, p50 / p90
of time to first token and to the last, tokens received a second, the
offered tokens a second, the queue's depth when the window closed and
the generator's lateness. The knee is the highest rate whose requests
all finish with no queue left at the close and whose tokens a second keep
up with the offered; a cell below it runs at 0.8 x the knee.
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
    cell, cfg, traffic, arch, _ = common.load_cell(args.workload)
    common.require_devices(cell["chips"])

    import torch

    from portbench.generators.serve_open_loop import requests as make_requests
    from portbench.runners import serve

    engine = serve.build_engine(arch, cell, cfg, args.seed, "cuda")
    engine.warmup(fit_cap_slope=False)
    ramp, drain = traffic["ramp_s"], traffic["drain_s"]
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        reqs = make_requests(traffic, args.seed + i, [ramp, args.seconds, drain],
                             cfg["num_text_tokens"], rate)
        serve.warm(engine, cfg, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w0, w1 = t0 + ramp, t0 + ramp + args.seconds
        rec = serve.drive(engine, reqs, t0, w0, w1, drain, None, torch.cuda.synchronize)
        stats = serve.summarize(rec, w0, w1)
        depth = [t["row"]["queue_depth"] for t in rec["ticks"]
                 if t["row"] is not None and t["t1"] <= w1]
        offered = sum(r[2] for r in reqs if r[3] == serve.WINDOW) / args.seconds
        stats.update(rate=rate, offered_tokens_per_s=offered,
                     queue_at_close=depth[-1] if depth else None,
                     queue_max=max(depth) if depth else None)
        print(json.dumps(stats), flush=True)
        # let the engine drain before the next rate
        while engine.has_work:
            engine.step()
    print(f"portbench: {common.power_limit()}", file=sys.stderr)


if __name__ == "__main__":
    main()
