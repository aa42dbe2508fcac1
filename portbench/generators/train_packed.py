"""Pretraining rows, packed to a fixed length (traffic kind `train_packed`).

Row `i` of a run is made from (seed, i) alone, lazily, so the loader can
draw any row without the others and the reference can make the same rows
again. A row concatenates documents until `row_len` positions are filled,
counting the packer's frame: one sos and one eos a row, and for each image
[meta][the chars of "h,w"][som] + h * w latent rows + [eom] (264
positions for a 16 x 16 latent). A document is, with probability `pair_share`, a
caption-image pair (a caption of `caption.min`-`caption.max` tokens, first
with probability `caption_first`), and otherwise a text document of
lognormal length (`text_doc`: median, sigma, clipped to min-max) with a
Poisson number of images (mean `images_per_text_token` x its length) at
uniform split points. The item that does not fit is cut (text) or turned
into text (an image) to fill the row exactly, so every row holds
`row_len` positions.
"""

from __future__ import annotations

import math

import numpy as np

def rng_for(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *keys]))


def image_head(shape) -> int:
    """The positions before an image's latent rows: [meta][chars][som]."""
    h, w = shape
    return 2 + len(f"{h},{w}")


def image_cost(traffic: dict) -> int:
    h, w = traffic["image_shape"]
    return image_head((h, w)) + h * w + 1


def _lognormal_len(rng, p: dict) -> int:
    x = math.exp(math.log(p["median"]) + p["sigma"] * rng.standard_normal())
    return int(min(max(round(x), p["min"]), p["max"]))


def _document(rng, traffic: dict) -> list:
    """[('t', n) | ('i',)] of one document."""
    if rng.random() < traffic["pair_share"]:
        c = int(rng.integers(traffic["caption"]["min"], traffic["caption"]["max"] + 1))
        return [("t", c), ("i",)] if rng.random() < traffic["caption_first"] else [("i",), ("t", c)]
    n = _lognormal_len(rng, traffic["text_doc"])
    k = int(rng.poisson(n * traffic["images_per_text_token"]))
    cuts = np.sort(rng.integers(0, n + 1, size=k))
    doc, prev = [], 0
    for c in cuts:
        if c > prev:
            doc.append(("t", int(c - prev)))
        doc.append(("i",))
        prev = int(c)
    if n > prev:
        doc.append(("t", n - prev))
    return doc


def row_layout(traffic: dict, seed: int, index: int) -> list:
    """The row's items [('t', n) | ('i',)] between its sos and eos, filling
    row_len positions exactly."""
    rng = rng_for(seed, 0, index)
    left = traffic["row_len"] - 2
    cost = image_cost(traffic)
    items = []
    while left > 0:
        for item in _document(rng, traffic):
            if item[0] == "i" and cost > left:
                item = ("t", left)
            n = item[1] if item[0] == "t" else cost
            if n > left:
                item, n = ("t", left), left
            items.append(item)
            left -= n
            if left == 0:
                break
    return items


class Rows:
    """The run's rows as a dataset: `rows[i]` is a sample for the port's
    packer, a list of int32 text arrays and (0, float32 latent [h, w, c])
    tuples; the ids and latents come from (seed, i)."""

    def __init__(self, traffic: dict, seed: int, num_text_tokens: int, dim_latent: int,
                 length: int = 1 << 30):
        self.traffic, self.seed = traffic, int(seed)
        self.num_text_tokens, self.dim_latent = num_text_tokens, dim_latent
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> list:
        layout = row_layout(self.traffic, self.seed, int(index))
        rng = rng_for(self.seed, 1, int(index))
        shape = (*self.traffic["image_shape"], self.dim_latent)
        out = []
        for item in layout:
            if item[0] == "t":
                out.append(rng.integers(0, self.num_text_tokens, size=item[1], dtype=np.int32))
            else:
                out.append((0, rng.standard_normal(shape, dtype=np.float32)))
        return out


def step_rows(traffic: dict, step: int) -> range:
    """The dataset indices of optimizer step `step` (0-based): the loader
    reads the rows in order, rows_per_step a step."""
    r = traffic["rows_per_step"]
    return range(step * r, (step + 1) * r)
