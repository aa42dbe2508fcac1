"""Structured metrics logging (counterpart of `MetricsLogger` in
`transfusion_tpu/training/metrics.py`): a JSONL stream of (step, wall time,
scalars) rows with an in-memory history and EWMA summaries. The serving
engines' `metrics=` argument logs one row a tick to it."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


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
