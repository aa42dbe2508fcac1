"""Host-side packing of ragged multimodal samples into static-shape buffers
(counterpart of `transfusion_tpu/data/packing.py`):

  text     Int[b, n]     token ids; -1 at modality interiors and padding
  cfg_mask Bool[b, n]    positions replaced by null_text_id under CFG dropout
  spans    Int[b, m, 3]  (modality_type, offset, length) per instance
  groups   per (type, latent shape) batches of channel-last latents with
           their scatter indices

Token ids: text 0..N-1; sos=N; eos=N+1; null=N+2; som_ids N+3..;
eom_ids after them; meta_id; char meta tokens meta_id+1 .. meta_id+128.
Per modality instance: [meta_id][shape chars][som] <interior, text=-1> [eom].

The first four buffers are assembled in one pass by the native packer
(`csrc/fastpack.cpp`, built with the host C++ compiler at first use and
loaded with ctypes) or by numpy (`_assemble`); both give the same bytes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from transfusion_tpu_torch.ops import _build
from transfusion_tpu_torch.utils.helpers import (
    char_tokenize,
    is_int_array,
    round_up_to_multiple,
)


@dataclasses.dataclass(frozen=True)
class ModalityPackSpec:
    dim_latent: int
    channel_first: bool = False
    num_dim: Optional[int] = None
    som_id: int = 0
    eom_id: int = 0
    # latent spatial shape -> sequence (post latent_to_model) spatial shape
    seq_shape_fn: Callable[[tuple], tuple] = lambda s: s


@dataclasses.dataclass(frozen=True)
class PackSpec:
    num_text_tokens: int
    sos_id: int
    eos_id: int
    null_text_id: int
    meta_id: int
    char_offset: int
    modalities: tuple


@dataclasses.dataclass(frozen=True)
class LatentGroup:
    latents: Any  # [k, *latent_shape, dim_latent] — channel-last
    batch_idx: Any  # Int[k]
    offsets: Any  # Int[k] — sequence offset of the interior start
    span_rows: Any  # Int[k] — row into spans / times
    modality_type: int
    latent_shape: tuple
    seq_shape: tuple

    @property
    def seq_len(self) -> int:
        return int(math.prod(self.seq_shape))

    def replace(self, **kw) -> "LatentGroup":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    text: Any  # Int[b, n]
    cfg_mask: Any  # Bool[b, n]
    spans: Any  # Int[b, m, 3]
    lengths: Any  # Int[b] true (unpadded) lengths
    total_tokens: Any
    groups: tuple  # LatentGroup, sorted by (type, shape)

    @property
    def batch(self) -> int:
        return self.text.shape[0]

    @property
    def seq_len(self) -> int:
        return self.text.shape[1]

    def replace(self, **kw) -> "PackedBatch":
        return dataclasses.replace(self, **kw)

    def to_torch(self, device) -> "PackedBatch":
        """The same batch with every array as a tensor on `device`: ids as
        int64, latents as float32."""
        def ids(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        groups = tuple(
            g.replace(
                latents=torch.as_tensor(np.asarray(g.latents), dtype=torch.float32, device=device),
                batch_idx=ids(g.batch_idx), offsets=ids(g.offsets),
                span_rows=ids(g.span_rows),
            )
            for g in self.groups
        )
        return self.replace(
            text=ids(self.text),
            cfg_mask=torch.as_tensor(np.asarray(self.cfg_mask), device=device),
            spans=ids(self.spans), lengths=ids(self.lengths),
            total_tokens=int(self.total_tokens), groups=groups,
        )


def to_channel_last(x: np.ndarray, channel_first: bool) -> np.ndarray:
    if channel_first and x.ndim > 1:
        return np.moveaxis(x, 0, -1)
    return x


def to_user_layout(x: np.ndarray, channel_first: bool) -> np.ndarray:
    if channel_first and x.ndim > 1:
        return np.moveaxis(x, -1, 0)
    return x


def normalize_sample(sample) -> list:
    """Float arrays -> (0, arr) tuples; 0-d int arrays -> 1-d."""
    out = []
    for item in sample:
        if isinstance(item, tuple):
            mtype, arr = item
            out.append((int(mtype), np.asarray(arr)))
            continue
        arr = np.asarray(item)
        if np.issubdtype(arr.dtype, np.floating):
            out.append((0, arr))
        else:
            if arr.ndim == 0:
                arr = arr[None]
            out.append(arr.astype(np.int32))
    return out


def _assemble(descriptors, n: int, m: int):
    """(text, cfg, spans, lengths) of the packer's descriptors: per sample a
    list of ("t", ids) and ("m", type, head ids, interior, eom) items."""
    batch = len(descriptors)
    text = np.full((batch, n), -1, np.int32)
    cfg = np.zeros((batch, n), bool)
    spans = np.zeros((batch, m, 3), np.int32)
    lengths = np.zeros(batch, np.int32)
    for b, items in enumerate(descriptors):
        off = 0
        si = 0
        for item in items:
            if item[0] == "t":
                ids = item[1]
                text[b, off : off + len(ids)] = ids
                cfg[b, off : off + len(ids)] = True
                off += len(ids)
            else:
                _, mtype, head, interior, eom = item
                text[b, off : off + len(head)] = head
                spans[b, si] = (mtype, off + len(head), interior)
                si += 1
                off += len(head) + interior
                if eom >= 0:
                    text[b, off] = eom
                    off += 1
        lengths[b] = off
    return text, cfg, spans, lengths


def _flatten(descriptors):
    """The descriptors as `csrc/fastpack.cpp` reads them: items int64 [k, 5]
    (kind, n_ids, type, interior, eom), counts int64 [b] (items a sample),
    ids int32 (every item's ids in order)."""
    rows, ids = [], []
    for items in descriptors:
        for item in items:
            if item[0] == "t":
                rows.append((0, len(item[1]), 0, 0, -1))
                ids.append(item[1])
            else:
                _, mtype, head, interior, eom = item
                rows.append((1, len(head), mtype, interior, eom))
                ids.append(head)
    counts = np.fromiter(map(len, descriptors), np.int64, len(descriptors))
    flat = np.concatenate(ids).astype(np.int32, copy=False) if ids else np.zeros(0, np.int32)
    return np.asarray(rows, np.int64).reshape(-1, 5), counts, np.ascontiguousarray(flat)


_FASTPACK_ARGTYPES = [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 7


def _assemble_native(descriptors, n: int, m: int):
    """`_assemble` in one native pass (`csrc/fastpack.cpp`); the library is
    built on first use, and a failed build raises with the compiler's
    output."""
    fn = _build.load("fastpack", _FASTPACK_ARGTYPES)
    items, counts, ids = _flatten(descriptors)
    b = len(descriptors)
    text, cfg = np.empty((b, n), np.int32), np.empty((b, n), bool)
    spans, lengths = np.empty((b, m, 3), np.int32), np.empty(b, np.int32)
    err = fn(b, n, m, *(a.ctypes.data for a in (items, counts, ids, text, cfg, spans, lengths)))
    if err:
        raise ValueError({1: f"a sample does not fit pad_len {n}",
                          2: f"a sample has more than {m} modalities"}.get(
                              err, f"fastpack: error {err}"))
    return text, cfg, spans, lengths


def pack_samples(samples: Sequence[list], spec: PackSpec, *, wrap_sos_eos: bool = True,
                 add_meta: bool = True, pad_multiple: int = 64,
                 pad_len: Optional[int] = None, span_multiple: int = 2,
                 use_native: bool = True, shift_friendly: bool = False) -> PackedBatch:
    """Pack ragged ModalitySamples (lists of int arrays / float arrays /
    (type, float array) tuples) into one PackedBatch of numpy arrays.

    wrap_sos_eos adds [sos] ... [eos]; add_meta writes the
    [meta][shape][som] ... [eom] frame around each modality (sampling passes
    False: the sampled stream already holds the frame). The meta string
    holds the latent shape; the span holds prod(seq_shape_fn(latent shape))
    rows (`Transfusion.encode_modalities` first when there are encoders). The padded length is
    round_up(max_len + 1, pad_multiple) unless pad_len is given.

    shift_friendly adds one slot, so that after the training step's
    next-token shift (text[:, :-1]) the model sees a length that is a
    multiple of pad_multiple; with it, pad_len must leave room for that
    slot beyond the longest sample.

    use_native assembles the buffers in the native packer (built at first
    use; a failed build raises), else in numpy: the same arrays."""
    num_modalities = len(spec.modalities)
    descriptors: list = []
    span_counts: list = []
    instances: list = []
    lengths_py: list = []

    for b, sample in enumerate(samples):
        sample = normalize_sample(sample)
        if wrap_sos_eos:
            sample = [np.array([spec.sos_id], np.int32), *sample,
                      np.array([spec.eos_id], np.int32)]
        items: list = []
        offset = 0
        span_count = 0
        for item in sample:
            if is_int_array(item) and not isinstance(item, tuple):
                ids = np.asarray(item, np.int32)
                items.append(("t", ids))
                offset += len(ids)
                continue

            mtype, latent = item
            if not 0 <= mtype < num_modalities:
                raise ValueError(
                    f"modality type {mtype} out of range ({num_modalities} modalities)"
                )
            mspec = spec.modalities[mtype]
            latent = np.asarray(latent, np.float32)
            channel_axis = 0 if mspec.channel_first and latent.ndim > 1 else -1
            if latent.shape[channel_axis] != mspec.dim_latent:
                raise ValueError(
                    f"modality {mtype}: expected latent dim {mspec.dim_latent}, got "
                    f"shape {latent.shape} (channel_first={mspec.channel_first})"
                )
            latent = to_channel_last(latent, mspec.channel_first)
            spatial = tuple(latent.shape[:-1])
            if mspec.num_dim is not None and len(spatial) != mspec.num_dim:
                raise ValueError(
                    f"modality {mtype}: expected {mspec.num_dim} spatial dims, got {spatial}"
                )
            seq_shape = tuple(mspec.seq_shape_fn(spatial))
            length = int(math.prod(seq_shape))

            if add_meta:
                meta_chars = char_tokenize(",".join(map(str, spatial)), offset=spec.char_offset)
                head = np.concatenate([
                    np.array([spec.meta_id], np.int32), meta_chars.astype(np.int32),
                    np.array([mspec.som_id], np.int32),
                ])
                eom = mspec.eom_id
            else:
                head = np.zeros(0, np.int32)
                eom = -1

            start = offset + len(head)
            items.append(("m", mtype, head, length, eom))
            instances.append(dict(batch=b, span_row=span_count, mtype=mtype, latent=latent,
                                  spatial=spatial, seq_shape=seq_shape, offset=start))
            span_count += 1
            offset = start + length + (1 if add_meta else 0)

        descriptors.append(items)
        span_counts.append(span_count)
        lengths_py.append(offset)

    max_len = max(lengths_py) if lengths_py else 1
    shift = 1 if shift_friendly else 0
    n = pad_len if pad_len is not None else (
        round_up_to_multiple(max(max_len, 1) + 1, pad_multiple) + shift
    )
    # an exact fit under shift_friendly would drop the last real token of a
    # longest sample in the shift
    if n < max_len + shift:
        raise ValueError(
            f"pad_len {n} too small for longest sample {max_len}"
            + (" + 1 shift slot (shift_friendly=True)" if shift_friendly else "")
        )
    m = max(span_multiple, round_up_to_multiple(max(span_counts, default=1), span_multiple))

    text, cfg, spans_arr, lengths = (_assemble_native if use_native else _assemble)(
        descriptors, n, m)

    keys = sorted({(i["mtype"], i["spatial"]) for i in instances})
    groups = []
    for key in keys:
        members = [i for i in instances if (i["mtype"], i["spatial"]) == key]
        groups.append(LatentGroup(
            latents=np.stack([i["latent"] for i in members]),
            batch_idx=np.array([i["batch"] for i in members], np.int32),
            offsets=np.array([i["offset"] for i in members], np.int32),
            span_rows=np.array([i["span_row"] for i in members], np.int32),
            modality_type=key[0], latent_shape=key[1],
            seq_shape=members[0]["seq_shape"],
        ))

    return PackedBatch(text=text, cfg_mask=cfg, spans=spans_arr, lengths=lengths,
                       total_tokens=np.int32(lengths.sum()), groups=tuple(groups))


# ---------------------------------------------------------------------------
# batched application of encoders/decoders over ragged samples
# ---------------------------------------------------------------------------


def group_same_shape(arrays: list):
    """Stack same-shape arrays into batches, with an exact-order inverse.
    Returns ({shape: stacked}, inverse)."""
    by_shape: dict = {}
    index: list = []
    for a in arrays:
        a = np.asarray(a)
        bucket = by_shape.setdefault(a.shape, [])
        index.append((a.shape, len(bucket)))
        bucket.append(a)
    stacked = {shape: np.stack(arrs) for shape, arrs in by_shape.items()}

    def inverse(processed: dict):
        return [np.asarray(processed[shape])[i] for shape, i in index]

    return stacked, inverse


def apply_modality_fn(fn: Callable, samples, modality_type: int = 0):
    """Apply the batched `fn` to every modality of `modality_type` in one
    sample (a list of items) or a list of samples, stacking same-shape
    instances into one call. A float array without a type is type 0.
    Keeps the structure and order."""
    single = len(samples) > 0 and not isinstance(samples[0], list)
    nested = [samples] if single else samples
    located = []
    for si, sample in enumerate(nested):
        for ii, item in enumerate(sample):
            if isinstance(item, tuple):
                t, arr = item
            else:
                arr = np.asarray(item)
                if not np.issubdtype(arr.dtype, np.floating):
                    continue
                t = 0
            if t == modality_type:
                located.append((si, ii, np.asarray(arr)))
    stacked, inverse = group_same_shape([arr for _, _, arr in located])
    results = inverse({shape: np.asarray(fn(batch)) for shape, batch in stacked.items()})
    out = [list(s) for s in nested]
    for (si, ii, _), res in zip(located, results):
        out[si][ii] = (modality_type, res)
    return out[0] if single else out
