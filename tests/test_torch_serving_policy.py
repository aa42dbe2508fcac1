"""PyTorch port: the dispatch planners (`models/serving.py`) and the chunk
chooser against the JAX package's. They are pure Python, so for the same
arguments the decisions must be equal and the estimated times equal within
1e-12 relative: the workloads of tests/test_serving_policy.py and 50
seeded random ones.

The port's default costs (`DEFAULT_RTT_S`, `DEFAULT_STEP_S`,
`DEFAULT_ODE_S`, `STATIC_STEP_RATIO`) are the card's and differ from the
JAX package's TPU values, so every comparison passes the costs
explicitly."""

import numpy as np
import pytest

from transfusion_tpu.models import engine as jax_engine
from transfusion_tpu.models import serving as jax_serving
from transfusion_tpu_torch.models import engine, serving

RTT, STEP, ODE = 0.03, 0.002, 1.0


def close(a, b):
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-30), (a, b)


def test_choose_chunk_and_width_bucket_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        rem = rng.integers(0, 600, int(rng.integers(0, 10))).tolist()
        rtt, step = float(rng.uniform(1e-4, 0.05)), float(rng.uniform(1e-4, 0.01))
        max_chunk = int(rng.choice([1, 7, 32, 64, 100, 256]))
        assert engine.choose_chunk(rem, rtt, step, max_chunk) == jax_engine.choose_chunk(
            rem, rtt, step, max_chunk), (rem, rtt, step, max_chunk)
    for n in [0, 1, 127, 128, 129, 255, 256, 257, 511, 512, 513, 900, 1025, 5000]:
        assert engine._width_bucket(n) == jax_engine._width_bucket(n)


def probe_a():
    rng = np.random.default_rng(0)
    _ = rng.integers(64, 512, 16)  # the probe's draw order
    budgets = np.concatenate([rng.integers(16, 48, 12), rng.integers(128, 192, 4)])
    rng.shuffle(budgets)
    return budgets.tolist()


def random_text(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 40))
    budgets = rng.integers(1, 400, n).tolist()
    pool = int(rng.integers(1, 12))
    rtt, step = float(rng.uniform(1e-4, 0.05)), float(rng.uniform(1e-4, 0.01))
    return budgets, pool, rtt, step, int(rng.choice([16, 64, 256]))


TEXT = ([("probe A", probe_a(), 8, 0.0367, 0.00261, 256),
         ("probe B", [256 if i % 8 == 0 else 16 for i in range(48)], 8, 0.0367, 0.00261, 256),
         ("uniform", [64] * 8, 8, 0.035, 0.0025, 256),
         ("bimodal", [256 if i % 8 == 0 else 16 for i in range(48)], 8, 0.035, 0.0025, 256),
         ("empty", [], 8, 0.035, 0.0025, 256)]
        + [(f"random {i}", *random_text(i)) for i in range(50)])


@pytest.mark.parametrize("name,budgets,pool,rtt,step,max_chunk", TEXT, ids=[t[0] for t in TEXT])
def test_text_planner_matches_jax(name, budgets, pool, rtt, step, max_chunk):
    if budgets:
        close(serving.estimate_static_time(budgets, pool, rtt, step),
              jax_serving.estimate_static_time(budgets, pool, rtt, step))
        close(serving.estimate_engine_time(budgets, pool, rtt, step, max_chunk),
              jax_serving.estimate_engine_time(budgets, pool, rtt, step, max_chunk))
    for kw in ({"static_step_ratio": 0.7}, {"static_step_ratio": 0.45},
               {"static_step_s": step * 0.9}, {"static_step_s": step * 0.3, "margin": 0.8}):
        got = serving.plan_dispatch(budgets, pool, rtt, step, max_chunk=max_chunk, **kw)
        assert got == jax_serving.plan_dispatch(budgets, pool, rtt, step, max_chunk=max_chunk,
                                                **kw), kw


def probe_shape():
    return ([(24, 0)] * 7 + [(40, 1)]) * 3


def random_mm(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(1, 30))
    reqs = [(int(rng.integers(1, 300)), int(rng.integers(0, 3))) for _ in range(n)]
    pool = int(rng.integers(1, 9))
    rtt, step = float(rng.uniform(1e-4, 0.05)), float(rng.uniform(1e-4, 0.01))
    ode = float(rng.uniform(0.01, 1.0))
    seg_cap = None if seed % 3 == 0 else int(rng.integers(4, 80))
    return reqs, pool, rtt, step, ode, int(rng.choice([0, 16, 196])), seg_cap


MM = ([("deep", ([(24, 0)] * 7 + [(512, 0)]) * 4, 8, RTT, STEP, ODE, 0, None),
       ("mixed", ([(24, 0)] * 7 + [(200, 2)]) * 4, 8, RTT, STEP, ODE, 196, None),
       ("clustered", [(64, 0)] * 8, 8, RTT, STEP, ODE, 196, None),
       ("mild", [(t, 0) for t in (48, 56, 64, 64, 72, 80, 88, 96)], 8, RTT, STEP, ODE, 0, None),
       ("probe", probe_shape(), 8, RTT, STEP, ODE, 196, None),
       ("empty", [], 8, RTT, STEP, ODE, 0, None)]
      + [(f"random {i}", *random_mm(i)) for i in range(50)])


@pytest.mark.parametrize("name,reqs,pool,rtt,step,ode,seg_tokens,seg_cap", MM,
                         ids=[t[0] for t in MM])
def test_mm_planner_matches_jax(name, reqs, pool, rtt, step, ode, seg_tokens, seg_cap):
    kw = dict(max_chunk=64, seg_cap=seg_cap, seg_tokens=seg_tokens)
    if reqs:
        for waves in (False, True):
            close(serving._simulate_mm(reqs, pool, rtt, step, ode, waves=waves, **kw),
                  jax_serving._simulate_mm(reqs, pool, rtt, step, ode, waves=waves, **kw))
    for margin in (0.95, 1.2):
        assert serving.plan_dispatch_mm(reqs, pool, rtt, step, ode, margin=margin, **kw) == \
            jax_serving.plan_dispatch_mm(reqs, pool, rtt, step, ode, margin=margin, **kw)


def test_default_costs_are_positive_and_stated():
    """The defaults the engines fall back to before a fit."""
    assert 0 < serving.STATIC_STEP_RATIO <= 1
    assert serving.DEFAULT_RTT_S > 0 and serving.DEFAULT_STEP_S > 0 and serving.DEFAULT_ODE_S > 0
    assert serving.plan_dispatch([], 8) == "static"
    assert serving.plan_dispatch_mm([], 8) == "waves"
