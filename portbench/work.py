"""The work a cell's traffic asks for, counted from the traffic itself (the
row layouts and the requests' lengths), never from the program's launches,
so that it reads the same whatever implements it. What the work costs in a
model's layers is its architecture's (`architectures/<name>.py`); the
counts here hold for any."""

from __future__ import annotations


def row_spans(layout: list, image_len: int, image_frame_head: int) -> list:
    """(offset, length) of each image's latent rows in a packed row: one
    sos first, then the items; an image is [meta][chars][som] + rows +
    [eom]."""
    pos, out = 1, []
    for item in layout:
        if item[0] == "t":
            pos += item[1]
        else:
            out.append((pos + image_frame_head, image_len))
            pos += image_frame_head + image_len + 1
    return out


def visible_pairs(n: int, spans: list) -> int:
    """The (query, key) pairs the Transfusion mask lets through in one row
    of n positions: the causal triangle, and inside each image the pairs
    ahead of the query."""
    return n * (n + 1) // 2 + sum(L * (L - 1) // 2 for _, L in spans)


def train_step_work(step: dict) -> dict:
    """Positions, text positions, image rows, images and visible pairs
    (summed over rows) of one optimizer step {'n': positions a row,
    'layouts': [row layout], 'image_len': rows an image, 'image_head':
    positions before an image's rows}."""
    n, L = step["n"], step["image_len"]
    pairs = text = images = 0
    for layout in step["layouts"]:
        spans = row_spans(layout, L, step["image_head"])
        pairs += visible_pairs(n, spans)
        images += len(spans)
        text += n - L * len(spans)
    rows = len(step["layouts"])
    return {"positions": rows * n, "text": text, "image_rows": images * L, "images": images,
            "pairs": pairs, "rows": rows}


def attention_flops(pair: tuple, pairs: int) -> float:
    """q k^T and p v over `pairs` visible pairs; pair: (q k widths, value
    widths) of one pair, heads x dim summed over the layers that attend
    (an architecture's `attention_pair`)."""
    qk, v = pair
    return 2.0 * (qk + v) * pairs


def attention_backward_flops(pair: tuple, pairs: int) -> float:
    """The backward of `attention_flops`: q k^T again, dO v^T, dV = P^T dO,
    dQ = dS k and dK = dS^T q."""
    qk, v = pair
    return 2.0 * (3 * qk + 2 * v) * pairs


def serve_work(ticks: list) -> dict:
    """The work of engine ticks (`runners/serve.drive`'s records): prompts
    prefilled (their true lengths and causal pairs), tokens decoded and
    the cache slots each decode step attends over (prompt + tokens so far
    + the token fed)."""
    prompts = prefill_tokens = prefill_pairs = decoded = kv = 0
    for t in ticks:
        for p in t["work"]["admitted"]:
            prompts += 1
            prefill_tokens += p
            prefill_pairs += p * (p + 1) // 2
        for p, e0, e1 in t["work"]["decoded"]:
            decoded += e1 - e0
            kv += sum(p + e + 1 for e in range(e0, e1))
    return {"prompts": prompts, "prefill_tokens": prefill_tokens,
            "prefill_pairs": prefill_pairs, "decoded": decoded, "decode_kv": kv}


def kernel_seconds(ctx: dict, pattern: str):
    """The device time of the trace's kernels whose names match `pattern`
    (a regular expression), or None when none ran."""
    import re

    rx = re.compile(pattern)
    times = [e - s for name, s, e in ctx["device_ops"] if rx.search(name)]
    return sum(times) if times else None


def roofline_share(ctx: dict, flops: float, nbytes: float, seconds) -> float | None:
    """100 x the least time the chip could take for the work (the larger of
    FLOPs over the bf16 peak and bytes over the HBM bandwidth) over the
    kernels' time; None when no kernel ran or there was no work."""
    if not seconds or not (flops or nbytes):
        return None
    pk = ctx["peaks"]
    bound = max(flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
