"""A minimal dataloader for ragged multimodal samples (counterpart of
`transfusion_tpu/data/dataloader.py`).

`DataLoader` collates a batch as a list of samples, each a list of its
items: nothing is padded here, the packer resolves the raggedness. The
order comes from numpy's `default_rng(seed)`, as in the JAX package, so the
same seed gives the same batches.

`PackingLoader` encodes and packs the next batches on a background thread
while the caller trains. Unlike the JAX loader, a worker that raises does
not leave `next()` waiting for ever: the exception is re-raised in the
caller.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

# how long a blocked queue call waits before it looks again at the
# loader's stop flag and its worker's liveness
_POLL_S = 0.1
# how long close() waits for the worker to finish a batch in progress
_JOIN_S = 10.0


class DataLoader:
    def __init__(self, dataset: Sequence, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[list]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield [list(self.dataset[int(i)]) for i in chunk]


def create_dataloader(dataset, batch_size: int = 1, shuffle: bool = False, **kw):
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, **kw)


def cycle(loader):
    while True:
        yield from loader


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PackingLoader:
    """Yields `PackedBatch`es (numpy, shift-friendly by default) of
    `model.encode_modalities(batch)` packed with `model.pack(batch,
    **pack_kw)`, made on a background thread up to `prefetch` batches
    ahead of the caller, epoch after epoch. The encoders run without a
    gradient on the model's device. An exception in the worker is raised
    by the next `next()`; `close()` stops and joins the worker."""

    def __init__(self, model, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, **pack_kw):
        self.model = model
        self.loader = DataLoader(dataset, batch_size, shuffle=shuffle, seed=seed)
        pack_kw.setdefault("shift_friendly", True)
        self.pack_kw = pack_kw
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="PackingLoader")
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item`, waiting for room until the loader is closed;
        False when it was closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    if len(self.loader) == 0:
                        raise ValueError(f"{len(self.loader.dataset)} samples make no batch "
                                         f"of {self.loader.batch_size}")
                    for batch in self.loader:
                        if self._stop.is_set():
                            return
                        batch = self.model.encode_modalities(batch)
                        if not self._put(self.model.pack(batch, **self.pack_kw)):
                            return
        except BaseException as e:  # handed to the caller, which re-raises it
            self._put(_WorkerError(e))

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("PackingLoader's worker stopped without a batch")
        if isinstance(item, _WorkerError):
            raise RuntimeError("PackingLoader's worker failed") from item.exc
        return item

    def close(self):
        """Stop the worker, drop the queued batches and join the thread
        (waiting at most `_JOIN_S` seconds for a batch in progress). Later
        `next()` calls raise StopIteration."""
        self._stop.set()
        self._drain()
        self._thread.join(_JOIN_S)
        self._drain()  # a put that won its race with the first drain

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return
