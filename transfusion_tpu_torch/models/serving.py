"""Serving policy (counterpart of `transfusion_tpu/models/serving.py`):
`plan_serving`, and the engine-vs-static dispatch planners `plan_dispatch`
and `plan_dispatch_mm` with their wall-clock estimators.

The JAX package picks the decode path and the KV dtype from crossovers
measured on its own accelerator. Those do not carry over to the H100, and
the port has not measured its own yet (queued in ROADMAP.md). Until it
does, the plan excludes the decode kernel only where the JAX plan does for
structure (a model that is not 'flash', or LASER), and the KV dtype is
int8 only when the caller passes `kv_quantize=True`. Every other
kernel-eligible cached step goes to the decode kernel;
`Transformer._use_decode_kernel` decides eligibility per call.

The dispatch planners are pure Python and return what the JAX planners
return for the same arguments. Their default costs are the card's:
`ServingEngine.warmup` and `MultimodalServingEngine.warmup` fit them on the
running device, and the engines pass their fitted values in.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """use_decode_kernel: cached steps may take the decode kernel.
    kv_quantize: int8 cache. reasons: one clause per decision, for logs."""

    use_decode_kernel: bool
    kv_quantize: bool
    reasons: tuple


def plan_serving(cache_capacity: int, batch: int, *, laser: bool = False, flash: bool = True,
                 kv_quantize: Optional[bool] = None) -> ServingPlan:
    """The decode route and KV dtype of a serving workload. The exclusions
    and their reasons are the JAX `plan_serving`'s; without a measured
    H100 crossover an eligible model keeps the kernel at any capacity."""
    quantize = bool(kv_quantize)
    excluded = None
    if not flash:
        excluded = "attn_impl != 'flash'"
    elif laser:
        excluded = "LASER attention (needs per-value renorm the kernel lacks)"
    if excluded is not None:
        reasons = [f"decode kernel excluded: {excluded}"]
    else:
        reasons = [f"decode kernel: every eligible cached step (cap {cache_capacity}, "
                   f"batch {batch}; H100 crossovers not measured yet)"]
    if quantize:
        reasons.append("int8 KV: requested")
    elif excluded is not None:
        reasons.append("bf16 KV: int8 only wins via the in-kernel dequant")
    else:
        reasons.append("bf16/f32 KV: int8 not requested")
    return ServingPlan(excluded is None, quantize, tuple(reasons))


# ---------------------------------------------------------------------------
# engine-vs-static dispatch planning
# ---------------------------------------------------------------------------

# Static decode runs over an exactly-sized cache while the engine's pool
# keeps its capacity for its lifetime: the static path's per-token cost
# over the engine's. Used only before `ServingEngine.warmup(fit_cap_slope=
# True)` or when its slope fit is rejected; afterwards `static_step_at`
# gives the fitted cost. Measured by chip_smoke.py phase 4c (`serve()` on
# both branches, the bench model) on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit: the card is host-bound, so dead cache slots cost little.
STATIC_STEP_RATIO = 0.944

# Default costs in seconds for callers without a fitted engine, and the
# engines' priors before their first fit: a chunk's fixed host cost (the
# launch, the payload's fetch and the bookkeeping), one decode step of the
# bench model over 8 rows, and one grouped ODE (16 midpoint steps, CFG,
# 14x14, 8 rows). Fitted by `MultimodalServingEngine.warmup` in
# chip_smoke.py phase 4c on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit; the host's speed moves them by up to 2x between machines.
DEFAULT_RTT_S = 0.02112
DEFAULT_STEP_S = 0.03093
DEFAULT_ODE_S = 0.9658


def choose_chunk(rem, rtt_s: float, step_s: float, max_chunk: int) -> int:
    """The decode-chunk length (a power of two up to max_chunk) that
    maximizes useful tokens per second: a chunk of k steps costs
    `rtt_s + k * step_s` and yields `sum_s min(rem_s, k)` useful tokens
    (rows retire inside the chunk, so overshooting a row's end is safe)."""
    rem = [int(r) for r in rem if r > 0]
    if not rem:
        return 1
    hi = min(max(rem), max_chunk)
    ladder, k = [], 1
    while k < hi:
        ladder.append(k)
        k <<= 1
    ladder.append(1 << (hi - 1).bit_length())  # round-up pow2: full drain
    best_k, best_rate = 1, -1.0
    for k in ladder:
        useful = sum(min(r, k) for r in rem)
        rate = useful / (rtt_s + k * step_s)
        if rate > best_rate:
            best_k, best_rate = k, rate
    return min(best_k, 1 << (max_chunk.bit_length() - 1))


def estimate_static_time(budgets, pool: int, rtt_s: float, step_s: float):
    """Wall-clock model of static batching (`generate_text_batch` over
    pools of `pool` requests, formed budget-descending as `serve()` forms
    them): each pool pays one prefill dispatch and one decode of its max
    budget."""
    t = 0.0
    bs = sorted((int(b) for b in budgets), reverse=True)
    for i in range(0, len(bs), pool):
        t += 2 * rtt_s + max(bs[i : i + pool]) * step_s
    return t


def estimate_engine_time(budgets, pool: int, rtt_s: float, step_s: float,
                         max_chunk: int = 256):
    """Wall-clock model of the `ServingEngine` loop: a greedy simulation with
    the engine's chunk chooser, longest budgets admitted first; one
    admission dispatch a wave, one dispatch plus k steps a chunk."""
    queue = deque(sorted((int(b) for b in budgets), reverse=True))
    slots: list = []
    t = 0.0
    guard = 0
    while queue or slots:
        guard += 1
        assert guard < 10_000, "engine-time simulation diverged"
        if queue and len(slots) < pool:
            t += rtt_s  # admission wave
            while queue and len(slots) < pool:
                slots.append(queue.popleft())
        k = choose_chunk(slots, rtt_s, step_s, max_chunk)
        t += rtt_s + k * step_s
        slots = [r - k for r in slots if r - k > 0]
    return t


def plan_dispatch(budgets, pool: int, rtt_s: float = DEFAULT_RTT_S,
                  step_s: float = DEFAULT_STEP_S, *,
                  static_step_ratio: float = STATIC_STEP_RATIO,
                  static_step_s: Optional[float] = None, margin: float = 0.95,
                  max_chunk: int = 256) -> str:
    """'engine' | 'static' for a batch of requests with known budgets: the
    engine is chosen when its estimate beats static batching's by `margin`
    (ties go to the simpler path). static_step_s: the static path's
    measured per-token cost (`ServingEngine.static_step_at`); None falls
    back to `step_s * static_step_ratio`."""
    if not budgets:
        return "static"
    e = estimate_engine_time(budgets, pool, rtt_s, step_s, max_chunk)
    s_step = static_step_s if static_step_s is not None else step_s * static_step_ratio
    s = estimate_static_time(budgets, pool, rtt_s, s_step)
    choice = "engine" if e < margin * s else "static"
    logger.info("plan_dispatch: engine~%.3fs static~%.3fs -> %s", e, s, choice)
    return choice


# ---------------------------------------------------------------------------
# multimodal engine-vs-waves dispatch planning
# ---------------------------------------------------------------------------


class _SimSlot:
    __slots__ = ("text_left", "segs_left", "to_park")

    def __init__(self, text, segs):
        self.text_left = int(text)
        self.segs_left = int(segs)
        # text tokens until the next [som] park (segments evenly interleaved)
        self.to_park = max(1, int(text) // (int(segs) + 1)) if segs else None


def _simulate_mm(reqs, pool, rtt_s, step_s, ode_s, *, waves, max_chunk, seg_cap=None,
                 seg_tokens=0):
    """Tick-level wall-clock model of the multimodal engine (waves=False:
    freed slots refill every tick) and of `sample_batch` waves (waves=True:
    a fresh pool only once the previous one drained), which run the same
    device functions. reqs: (text_tokens, n_segments) per request; each
    segment takes `seg_tokens` slots of the length budget; ode_s: one
    grouped ODE dispatch, whatever its member count."""
    reqs = sorted(reqs, key=lambda r: -(r[0] + r[1] * seg_tokens))
    queue = deque(_SimSlot(t, s) for t, s in reqs)
    slots: list = []
    t = 0.0
    guard = 0
    while queue or slots:
        guard += 1
        assert guard < 100_000, "mm dispatch simulation diverged"
        if queue and len(slots) < pool and (not waves or not slots):
            t += rtt_s  # admission prefill
            while queue and len(slots) < pool:
                slots.append(queue.popleft())
            t += rtt_s  # the pick after admission
        streaming = [s for s in slots if s.text_left > 0]
        if streaming:
            rem = []
            for s in streaming:
                r = s.text_left
                if s.to_park is not None:
                    r = min(r, s.to_park)
                if seg_cap is not None:
                    r = min(r, seg_cap)
                rem.append(max(1, r))
            k = choose_chunk(rem, rtt_s, step_s, max_chunk)
            t += rtt_s + k * step_s
            for s in streaming:
                adv = min(k, s.text_left)
                if s.to_park is not None:
                    adv = min(adv, s.to_park)
                s.text_left -= adv
                if s.to_park is not None:
                    s.to_park -= adv
        parked = [s for s in slots if s.segs_left > 0 and (s.to_park == 0 or s.text_left <= 0)]
        if parked:
            t += ode_s  # one grouped dispatch serves every parked slot
            for s in parked:
                s.segs_left -= 1
                s.to_park = max(1, s.text_left // (s.segs_left + 1)) if s.segs_left else None
        slots = [s for s in slots if s.text_left > 0 or s.segs_left > 0]
    return t


def plan_dispatch_mm(reqs, pool: int, rtt_s: float = DEFAULT_RTT_S,
                     step_s: float = DEFAULT_STEP_S, ode_s: float = DEFAULT_ODE_S, *,
                     margin: float = 0.95, max_chunk: int = 64, seg_cap=None,
                     seg_tokens: int = 0) -> str:
    """'engine' | 'waves' for a multimodal workload of (text_budget,
    n_segments) requests: the `MultimodalServingEngine` against fixed
    `sample_batch` waves of `pool` requests, decided as `plan_dispatch`
    decides."""
    if not reqs:
        return "waves"
    kw = dict(max_chunk=max_chunk, seg_cap=seg_cap, seg_tokens=seg_tokens)
    e = _simulate_mm(reqs, pool, rtt_s, step_s, ode_s, waves=False, **kw)
    w = _simulate_mm(reqs, pool, rtt_s, step_s, ode_s, waves=True, **kw)
    choice = "engine" if e < margin * w else "waves"
    logger.info("plan_dispatch_mm: engine~%.3fs waves~%.3fs -> %s", e, w, choice)
    return choice
