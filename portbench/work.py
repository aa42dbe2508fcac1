"""The work a cell's traffic asks for, counted from the traffic itself (the
row layouts and the requests' lengths), never from the program's launches,
so that it reads the same whatever implements it."""

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


def block_matmul_params(cfg: dict, i: int) -> int:
    """The weights that every position of block i multiplies by."""
    d, h, dh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["head_dim"]
    inner = h * dh
    fi = int(d * cfg["ff_expansion_factor"] * 2 / 3)
    p = 2 * inner * d + inner * d + inner * d + h * d + (h * d if i > 0 else 0)
    p += 2 * fi * d + fi * d
    if i >= cfg["num_hidden_layers"] / 2:
        p += 2 * d * d
    return p


def forward_flops(cfg: dict, w: dict) -> float:
    """The forward's model FLOPs (2 a multiply-add) of the work `w`: every
    position through the blocks, the text head on text positions, the
    latent projections on image rows, the conditioning of each image, and
    attention over the visible pairs (q k^T and p v)."""
    d, V = cfg["hidden_size"], cfg["num_text_tokens"] + 134
    depth = cfg["num_hidden_layers"]
    inner = cfg["num_attention_heads"] * cfg["head_dim"]
    per_pos = sum(block_matmul_params(cfg, i) for i in range(depth))
    flops = 2.0 * per_pos * w["positions"]
    flops += 2.0 * V * d * w["text"]
    flops += 2.0 * 2 * cfg["dim_latent"] * d * w["image_rows"]
    flops += 2.0 * w["images"] * ((d + 1) * 4 * d + depth * 2 * 12 * d * d)
    flops += 4.0 * inner * w["pairs"] * depth
    return flops


def attention_forward_flops(cfg: dict, pairs: int) -> float:
    """q k^T and p v over `pairs` visible pairs, every layer."""
    inner = cfg["num_attention_heads"] * cfg["head_dim"]
    return 4.0 * inner * pairs * cfg["num_hidden_layers"]


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


def model_step_params(cfg: dict) -> int:
    """The weights a text position multiplies by through the blocks."""
    return sum(block_matmul_params(cfg, i) for i in range(cfg["num_hidden_layers"]))


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
