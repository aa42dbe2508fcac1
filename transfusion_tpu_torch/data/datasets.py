"""Offline datasets for the example scripts (counterpart of
`transfusion_tpu/data/datasets.py`): the same arrays from the same files,
or the same deterministic stand-ins (each logged) when the files are
absent. Nothing is downloaded.

Files are read from `TRANSFUSION_DATA_DIR` (default `./data`):
`enwik8.gz` / `enwik8`, `mnist.npz` and `flowers/labels.txt` (the JAX
package reads the flowers labels from a fixed path outside the repository
instead).
"""

from __future__ import annotations

import gzip
import logging
import os
from pathlib import Path

import numpy as np

logger = logging.getLogger("transfusion_tpu_torch")

DATA_DIR = Path(os.environ.get("TRANSFUSION_DATA_DIR", "./data"))


def load_enwik8(path=None, n_bytes: int = 5_000_000) -> np.ndarray:
    """The first `n_bytes` of enwik8 as uint8; without the file, this
    repository's own `.py` then `.md` files (real text, always present),
    repeated to `n_bytes`."""
    for c in (path, DATA_DIR / "enwik8.gz", DATA_DIR / "enwik8"):
        if c and Path(c).exists():
            p = Path(c)
            if p.suffix == ".gz":
                with gzip.open(p, "rb") as f:
                    raw = f.read(n_bytes)
            else:
                raw = p.read_bytes()[:n_bytes]
            return np.frombuffer(raw, np.uint8).copy()

    logger.warning("enwik8 not found — falling back to repo source text")
    root = Path(__file__).resolve().parents[2]
    chunks, total = [], 0
    for p in sorted(root.rglob("*.py")) + sorted(root.rglob("*.md")):
        if ".git" in p.parts:
            continue
        b = p.read_bytes()
        chunks.append(b)
        total += len(b)
        if total >= n_bytes:
            break
    data = b"".join(chunks)
    reps = max(1, n_bytes // max(len(data), 1) + 1)
    return np.frombuffer((data * reps)[:n_bytes], np.uint8).copy()


def _synthetic_digit(rng: np.random.Generator, label: int) -> np.ndarray:
    """A procedural 28x28 'digit': a ring whose centre and radius depend on
    the label, a vertical bar for odd labels and a horizontal one from 5
    up, plus a little noise, clipped to [0, 1]."""
    img = np.zeros((28, 28), np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    cx, cy = 14 + 3 * np.cos(label), 14 + 3 * np.sin(label * 2)
    r_out = 6.0 + (label % 5)
    r_in = max(1.0, r_out - 2.5)
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    img[(d < r_out) & (d > r_in)] = 1.0
    if label % 2 == 1:
        img[6:22, 13 + (label % 3):15 + (label % 3)] = 1.0
    if label >= 5:
        img[13:15, 6:22] = 1.0
    img += rng.normal(0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def load_mnist(path=None, n: int = 4096):
    """(images Float32[n, 28, 28] in [0, 1], labels Int32[n]): MNIST's
    training set from `mnist.npz`, else synthetic digits of
    `default_rng(0)`."""
    for c in (path, DATA_DIR / "mnist.npz"):
        if c and Path(c).exists():
            with np.load(c) as z:
                imgs = z["x_train"][:n].astype(np.float32) / 255.0
                labels = z["y_train"][:n].astype(np.int32)
            return imgs, labels

    logger.warning("MNIST not found — using synthetic procedural digits")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.stack([_synthetic_digit(rng, int(label)) for label in labels])
    return imgs, labels


def load_flowers_latents(n: int = 1024, hw: int = 32, c: int = 4):
    """Stand-ins for the Oxford flowers' AutoencoderKL latents [n, hw, hw,
    c]: normal fields average-pooled 2x2 (spatially smooth), scaled by the
    Stable Diffusion latent factor 0.18215."""
    logger.warning("flowers VAE latents unavailable — using synthetic latents")
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, hw * 2, hw * 2, c)).astype(np.float32)
    return base.reshape(n, hw, 2, hw, 2, c).mean(axis=(2, 4)) * 0.18215


def load_flowers_labels() -> list[str]:
    """The flower species names, one a line of `flowers/labels.txt`, else
    'flower species 0' .. 'flower species 99'."""
    p = DATA_DIR / "flowers" / "labels.txt"
    if p.exists():
        return [line.strip() for line in p.read_text().splitlines() if line.strip()]
    return [f"flower species {i}" for i in range(100)]
