"""Open-loop request traffic (traffic kind `serve_open_loop`).

Requests arrive on a schedule whatever the system does, at `rate`
requests a second, over consecutive stretches of time (a run's ramp before
the window, the window, and the time after it). Each stretch holds
round(rate x its length) requests, and every seed gets the same multiset
in it: prompt lengths, output budgets and gaps between arrivals, each taken
at the n stratified quantiles (i + 0.5) / n of its distribution (lognormal
lengths clipped to [min, max]; exponential gaps, scaled to fill the
stretch). The seed permutes each list and draws the token ids. So seeds
differ in order, not in the work due in the window. A prompt starts with
the sos id.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

from portbench.generators.train_packed import rng_for


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lognormal(q: np.ndarray, p: dict) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf(float(u)) for u in q])
    x = np.exp(math.log(p["median"]) + p["sigma"] * z)
    return np.clip(np.round(x), p["min"], p["max"]).astype(np.int64)


def requests(traffic: dict, seed: int, stretches: list, num_text_tokens: int,
             rate: float | None = None) -> list:
    """[(due seconds from the start, prompt int32 array, output budget,
    stretch index)] in order of arrival over consecutive stretches of the
    given lengths. `rate` overrides the traffic's (the sweep)."""
    rate = traffic["rate"] if rate is None else rate
    sos = num_text_tokens
    out, start = [], 0.0
    for s, length in enumerate(stretches):
        n = max(1, round(rate * length))
        rng = rng_for(seed, 2, s)
        q = _quantiles(n)
        prompts = rng.permutation(_lognormal(q, traffic["prompt"]))
        budgets = rng.permutation(_lognormal(q, traffic["output"]))
        gaps = rng.permutation(-np.log1p(-q))
        gaps *= length / gaps.sum()
        due = start + np.cumsum(gaps) - gaps
        for i in range(n):
            ids = rng.integers(0, num_text_tokens, size=int(prompts[i]), dtype=np.int32)
            ids[0] = sos
            out.append((float(due[i]), ids, int(budgets[i]), s))
        start += length
    return out
