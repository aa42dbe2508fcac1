"""Observability (counterpart of `transfusion_tpu/training/metrics.py`):

  * `MetricsLogger`: a JSONL stream of (step, wall time, scalars) rows with
    an in-memory history and EWMA summaries. The serving engines'
    `metrics=` argument logs one row a tick to it; the `Trainer` one row a
    step;
  * `ProfilerHook`: a `torch.profiler` trace (CPU, and CUDA where there is
    a card) of a window of training steps, written to a directory as a
    Chrome trace;
  * `span(name)`: a host range at a layer boundary of the program. While a
    `torch.profiler` records, it is a `record_function` range in the same
    trace as the device's kernels, on the same clock; otherwise a shared
    no-op after one check. The program's spans, all on the calling thread:

      trainer (`Trainer.train_step`)  transfusion.train.step, and inside it
                                      .batch (encode, pack, to the device),
                                      .draws (the loss's draws and
                                      denominators), .forward and .backward
                                      (each microbatch), .reduce (the mesh's
                                      reduction, the accumulation's sum),
                                      .update, .log (with `metrics_path`)
      loader (`PackingLoader`)        transfusion.loader.next: the caller
                                      waiting for a packed batch
      serving (`ServingEngine.step`)  transfusion.engine.tick, and inside it
                                      .admit (with one .prefill a width
                                      group, args its width and rows),
                                      .plan (the chunk length), .decode (the
                                      chunk's launches), .fetch (the host
                                      blocked on the chunk), .retire
      moonlight layers                transfusion.attn.mla (the latent
      (`models/moonlight.py`)         projections and the heads' assembly);
                                      transfusion.moe.route (router, top-k,
                                      weights, the sort and group offsets),
                                      .experts (the grouped products),
                                      .combine, .shared; in the forward and
                                      again in a remat's recompute

    A training step opens at most 8 spans, plus 3 for each microbatch after
    the first (4 on a mesh); a tick at most 6, plus 1 a prefill group.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch
from torch._C._autograd import _profiler_enabled


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, ewma: float = 0.98):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        else:
            self._fh = None
        self.history: list[dict] = []
        self._ewma_coef = ewma
        self._ewma: dict[str, float] = {}
        self._t_last: Optional[float] = None

    def log(self, step: int, metrics: dict, tokens: Optional[int] = None):
        now = time.time()
        row = {"step": int(step), "time": now}
        for k, v in metrics.items():
            v = float(v)
            row[k] = v
            prev = self._ewma.get(k, v)
            self._ewma[k] = prev * self._ewma_coef + v * (1 - self._ewma_coef)

        if self._t_last is not None:
            row["step_seconds"] = now - self._t_last
            if tokens is not None:
                row["tokens_per_sec"] = tokens / max(row["step_seconds"], 1e-9)
        self._t_last = now

        self.history.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def ewma(self, key: str) -> Optional[float]:
        return self._ewma.get(key)

    def close(self):
        if self._fh:
            self._fh.close()


class ProfilerHook:
    """Trace steps [start_step, start_step + num_steps): call it with the
    step about to run; the trace goes to
    `logdir/trace_steps_{start}-{stop}.json` when the window closes."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 3):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def __call__(self, step: int):
        if step == self.start_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop_step and self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.logdir, f"trace_steps_{self.start_step}-{self.stop_step}.json"))
            self._prof = None


# the span of a process with no profiler recording (stateless, so shared)
_NO_SPAN = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A context over a layer boundary named `name`
    (`transfusion.<layer>.<what>`): a `torch.profiler.record_function`
    range while a profiler records, else the shared no-op (nothing is
    allocated and no clock is read)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name, args)
