"""Serving policy (counterpart of `transfusion_tpu/models/serving.py`
`plan_serving`).

The JAX package picks the decode path and the KV dtype from crossovers
measured on its own accelerator. Those do not carry over to the H100, and
the port has not measured its own yet (queued in ROADMAP.md). Until it
does, the plan decides only the KV dtype: int8 when the caller passes
`kv_quantize=True`. Every kernel-eligible cached step goes to the decode
kernel; `Transformer._use_decode_kernel` decides eligibility per call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """kv_quantize: int8 cache. reason: one clause, for logs."""

    kv_quantize: bool
    reason: str


def plan_serving(cache_capacity: int, batch: int, *,
                 kv_quantize: Optional[bool] = None) -> ServingPlan:
    quantize = bool(kv_quantize)
    return ServingPlan(quantize, (
        f"{'int8 KV: requested' if quantize else 'bf16/f32 KV: int8 not requested'} "
        f"(cap {cache_capacity}, batch {batch}; H100 crossovers not measured yet)"
    ))
