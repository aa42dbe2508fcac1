"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `portbench/cells/<cell>.json`; it names its configuration
(`configs/`), whose `architecture` (default `transfusion`) names the module
of `architectures/` that builds the model, makes its weights, holds its
plain reference and counts its work, and its traffic (`traffic/`), whose
`runner` (default by its `kind`) names the module of `runners/` that
drives it. The run sets up, warms up, measures for `--seconds`, checks
what the timed path produced against the plain reference (`reference/`)
and prints, as its last line, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, each read by `layer_metrics/<name>.py`),
`device` and, traced, `breakdown`, then `checks` (each number compared,
with its limit), which the last lines of standard error repeat. Which
metrics a cell reports is read from BENCHMARK.json at the checkout's root.

Without a CUDA device with enough cards, or with JAX or the JAX package
loaded, it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common  # noqa: E402


def cell_metrics(cell_name: str) -> tuple[list, list]:
    """(end-to-end entries, per-layer entries) of BENCHMARK.json that the
    cell reports; a cell the manifest does not list yet (one being tried
    out) reports every metric its runner and readers produce."""
    with open(common.CHECKOUT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    listed = cell_name in {w["name"] for w in manifest["workloads"]}

    def applies(entry, e2e_names=None):
        if not listed:
            return True
        if "workloads" in entry:
            return cell_name in entry["workloads"]
        return e2e_names is None or entry["moves"] in e2e_names

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in manifest["per_layer"] if applies(m, names)]


def layer_metrics(entries: list, ctx: dict) -> dict:
    out = {}
    for entry in entries:
        value = common.load_reader(entry["name"]).read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cell_override: dict | None = None, started: float | None = None,
             root=common.ROOT) -> tuple[dict, dict]:
    """(result line without checks, checks) of one run. `cell_override`
    replaces the cell's files (tests run a tiny configuration on the CPU
    through it); `started`: when set-up began (`time.perf_counter()`);
    `root`: the directory the cell's files and modules are found under."""
    if cell_override is None:
        cell, cfg, traffic, arch, runner = common.load_cell(name, root)
    else:
        cell, cfg, traffic = (cell_override[k] for k in ("cell", "cfg", "traffic"))
        arch, runner = common.architecture(cfg, root), common.runner(traffic, root)
    if device == "cuda":
        common.require_devices(cell["chips"])
    raw, checks = runner.run(arch, cell, cfg, traffic, seed, seconds, trace, device=device,
                             started=started)
    e2e, per_layer = cell_metrics(name) if cell_override is None else ([], [])
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": raw["attempted"], "failed": raw["failed"]}
    if trace:
        ctx = raw["layer_ctx"]
        if device == "cuda":
            ctx["peaks"] = common.peaks(raw["device"]["kind"])
        result["metrics"] = layer_metrics(per_layer, ctx)
        result["device"] = dict(raw["device"], busy_s=ctx["busy_s"],
                                window_s=ctx["trace_window_s"])
        result["breakdown"] = ctx["breakdown"]
    else:
        wanted = {m["name"] for m in e2e} if cell_override is None else set(raw["metrics"])
        result["metrics"] = {k: v for k, v in raw["metrics"].items() if k in wanted}
        result["device"] = raw["device"]
    if device == "cuda":
        print(f"portbench: {common.power_limit()}", file=sys.stderr)
    return result, checks


def main(argv=None):
    started = time.perf_counter()  # set-up counts from here: the port's imports are in it
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    common.set_cache_env()
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              started=started)
    common.emit(result, checks)


if __name__ == "__main__":
    main()
