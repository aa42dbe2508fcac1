"""What every run of the benchmark shares: the files of a cell (with its
architecture and runner, found by name), the checks on the device and on
the modules loaded, the device trace's reduction, the per-layer metric
readers and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent  # portbench/
CHECKOUT = ROOT.parent
# the build and kernel caches of a run: fixed paths inside the checkout, so
# that only a checkout's first run builds
CACHE_DIR = CHECKOUT / "build" / "portbench-cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transfusion_tpu")
# the harness's own spans around its calls into the program (they name the
# host's work in a traced run's idle gaps)
SPAN_PREFIX = "portbench."


def span(name: str):
    """A profiler range named portbench.<name> around a call into the
    program."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def set_cache_env():
    """Point every cache a run could write at the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE_DIR / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE_DIR / "cuda"))


# what an architecture module (architectures/<name>.py) gives the harness
HOOKS = ("check_config", "spec", "fill_value", "build_model", "load_weights",
         "unserved_leaves", "reference", "forward_flops", "serve_flops", "attention_pair",
         "flash_position_bytes", "cache_slot_bytes")
# the runner of a traffic kind whose file names none
KIND_RUNNERS = {"train_packed": "train", "serve_open_loop": "serve"}


def load_json(*parts, root: Path = ROOT) -> dict:
    with open(Path(root).joinpath(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> tuple:
    """(cell, configuration, traffic, architecture, runner) of the cell
    `name`, from cells/<name>.json, configs/<config>.json,
    traffic/<traffic>.json and the modules `architecture` and `runner`
    find, all under `root`."""
    cell = load_json("cells", f"{name}.json", root=root)
    cfg = load_json("configs", f"{cell['config']}.json", root=root)
    traffic = load_json("traffic", f"{cell['traffic']}.json", root=root)
    return cell, cfg, traffic, architecture(cfg, root), runner(traffic, root)


def architecture(cfg: dict, root: Path = ROOT):
    """The module `root`/architectures/<cfg's "architecture", default
    "transfusion">.py, which defines every name of HOOKS."""
    name = cfg.get("architecture", "transfusion")
    arch = _load_module(Path(root) / "architectures" / f"{name}.py", "architecture")
    missing = [h for h in HOOKS if not hasattr(arch, h)]
    if missing:
        raise SystemExit(f"portbench: the architecture {arch.__file__} lacks {missing}")
    return arch


def runner(traffic: dict, root: Path = ROOT):
    """The module `root`/runners/<traffic's "runner", default by its
    "kind">.py, whose `run` drives a cell of that traffic."""
    name = traffic.get("runner", KIND_RUNNERS.get(traffic.get("kind")))
    if name is None:
        raise SystemExit(f"portbench: the traffic kind {traffic.get('kind')!r} has no runner: "
                         f"name one as \"runner\": \"<module>\" ({Path(root) / 'runners'}"
                         f"/<module>.py)")
    return _load_module(Path(root) / "runners" / f"{name}.py", "runner")


def _load_module(path: Path, what: str):
    """The module at `path` (loaded by path: names may hold dots), or exit
    naming the file looked for."""
    if not path.is_file():
        raise SystemExit(f"portbench: no {what} {path.stem!r}: {path} not found")
    spec = importlib.util.spec_from_file_location(f"portbench_{what}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str):
    """The `read(ctx)` of layer_metrics/<metric>.py."""
    return _load_module(ROOT / "layer_metrics" / f"{metric}.py", "metric")


def peaks(kind: str) -> dict:
    """The published peaks of the device named `kind` (peaks.json)."""
    table = load_json("peaks.json")
    for entry in table["devices"]:
        if entry["match"] in kind:
            return entry
    raise SystemExit(f"portbench: no peak figures for the device {kind!r} in peaks.json")


def require_devices(chips: int):
    """The cell's devices, or exit without a result."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} devices, "
                       f"{torch.cuda.device_count()} present")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# -- the device trace -------------------------------------------------------


def profiled(cuda: bool) -> list:
    """The profiler's activities: the host, and the card when there is one."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    return acts + [torch.profiler.ProfilerActivity.CUDA] if cuda else acts


def trace_events(prof) -> tuple[list, list]:
    """(device ops, host ops) of a finished `torch.profiler.profile`, each
    [(name, start_s, end_s)] on the host's clock base. Device ops are the
    kernels, copies and sets the card ran; annotations are left out."""
    import torch

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", lambda: False)() or e.name().startswith(
                    SPAN_PREFIX):
                continue
            dev.append((e.name(), start, start + dur))
        else:
            host.append((e.name(), start, start + dur))
    return dev, host


def union_seconds(intervals, lo: float, hi: float) -> float:
    """The length of the union of [start, end) intervals inside [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(dev, host, lo: float, hi: float, top: int = 10) -> dict:
    """The device ops that took most time (by name), and the longest idle
    gaps of the device, each named by the innermost host op that was
    running at the gap's middle."""
    by_name: dict = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, cur = [], lo
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        covering = [(e - s, name) for name, s, e in host if s <= mid < e]
        label = min(covering)[1] if covering else "no host op"
        named.append([label, g1 - g0])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def device_info(torch, count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def emit(result: dict, checks: dict):
    """Print the checks on standard error, then the result line (checks
    last) on standard output, and exit. A run that loaded JAX or the JAX
    package prints no result."""
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        sys.exit(3)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
