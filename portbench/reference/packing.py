"""The reference's own packing of training rows (the layout the port's
packer is documented to make, written out again here): per row
[sos] items [eos], padded with -1 to `n` positions; a text item's ids are
its ids; an image is [meta][the chars of "h,w"][som], its h * w latent
rows (-1 in the ids), then [eom]. Text positions (sos and eos included)
are the ones a CFG drop replaces. Spans (type, offset, length) are padded
to an even count, at least 2."""

from __future__ import annotations

import numpy as np
import torch


def ids(num_text_tokens: int) -> dict:
    N = num_text_tokens
    return {"sos": N, "eos": N + 1, "null": N + 2, "som": N + 3, "eom": N + 4, "meta": N + 5,
            "char": N + 6}


def pack(rows: list, n: int, num_text_tokens: int, device) -> dict:
    """rows: samples (int arrays and (0, latent [h, w, c]) tuples) ->
    {'text', 'cfg_mask', 'spans', 'img_row', 'img_inst', 'img_off',
    'latents', 'total_tokens'} as tensors on `device`."""
    t = ids(num_text_tokens)
    b = len(rows)
    text = np.full((b, n), -1, np.int64)
    cfg = np.zeros((b, n), bool)
    counts = [sum(1 for it in r if isinstance(it, tuple)) for r in rows]
    m = max(2, -(-max(counts) // 2) * 2)
    spans = np.zeros((b, m, 3), np.int64)
    img_row, img_inst, img_off, lats = [], [], [], []
    total = 0
    for r, row in enumerate(rows):
        pos, inst = 0, 0
        text[r, 0], cfg[r, 0] = t["sos"], True
        pos = 1
        for it in row:
            if isinstance(it, tuple):
                lat = np.asarray(it[1], np.float32)
                h, w = lat.shape[:2]
                head = [t["meta"]] + [ord(c) + t["char"] for c in f"{h},{w}"] + [t["som"]]
                text[r, pos:pos + len(head)] = head
                pos += len(head)
                spans[r, inst] = (0, pos, h * w)
                img_row.append(r)
                img_inst.append(inst)
                img_off.append(pos)
                lats.append(lat)
                pos += h * w
                text[r, pos] = t["eom"]
                pos += 1
                inst += 1
            else:
                k = len(it)
                text[r, pos:pos + k] = it
                cfg[r, pos:pos + k] = True
                pos += k
        text[r, pos], cfg[r, pos] = t["eos"], True
        pos += 1
        if pos > n:
            raise ValueError(f"row {r} holds {pos} positions, more than {n}")
        total += pos

    def tens(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {"text": tens(text), "cfg_mask": tens(cfg, torch.bool), "spans": tens(spans),
            "img_row": tens(img_row), "img_inst": tens(img_inst), "img_off": tens(img_off),
            "latents": tens(np.stack(lats), torch.float32) if lats else torch.zeros(
                (0, 1, 1, 1), device=device),
            "total_tokens": total}
