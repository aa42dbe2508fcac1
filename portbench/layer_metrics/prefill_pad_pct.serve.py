"""The share of the prefills' positions that were padding: 100 x (1 - the
admitted prompts' tokens / the positions their width buckets dispatched),
from the engine's `prompt_tokens` and `prefill_positions` summed over the
window's ticks outside the profiled ones (source: program_counter)."""

from portbench.spans import tick_rows


def read(ctx):
    rows = tick_rows(ctx["outside_ticks"], "prefill_positions")
    positions = sum(r["prefill_positions"] for r in rows)
    if not positions:
        return None
    return 100.0 * (1.0 - sum(r["prompt_tokens"] for r in rows) / positions)
