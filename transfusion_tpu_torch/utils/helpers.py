"""Host-side helpers (counterpart of `transfusion_tpu/utils/helpers.py`)
plus device resolution for the port's entry points. A modality sample's
items may be numpy arrays or torch tensors (on any device)."""

from __future__ import annotations

import numpy as np
import torch


def exists(v) -> bool:
    return v is not None


def default(v, d):
    return v if v is not None else d


def identity(t, *args, **kwargs):
    return t


def first(it):
    return it[0]


def divisible_by(num, den) -> bool:
    return (num % den) == 0


def cast_tuple(t, length: int = 1) -> tuple:
    return t if isinstance(t, tuple) else ((t,) * length)


def round_up_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: with
    `device=None` it takes `cuda` and raises when no GPU is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "transfusion_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# modality sample structure helpers (items: int arrays = text, float arrays
# = modality type 0, (type, float array) tuples)
# ---------------------------------------------------------------------------


def is_int_array(t) -> bool:
    if isinstance(t, torch.Tensor):
        return not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool)
    return hasattr(t, "dtype") and np.issubdtype(np.asarray(t).dtype, np.integer)


def is_float_array(t) -> bool:
    if isinstance(t, torch.Tensor):
        return t.is_floating_point()
    return hasattr(t, "dtype") and np.issubdtype(np.asarray(t).dtype, np.floating)


def concat_contiguous_text(modality_sample: list) -> list:
    """Merge adjacent integer (text) arrays inside one modality sample."""
    output: list = []
    for item in modality_sample:
        if (
            output
            and not isinstance(item, tuple)
            and not isinstance(output[-1], tuple)
            and is_int_array(item)
            and is_int_array(output[-1])
        ):
            output[-1] = np.concatenate([np.asarray(output[-1]), np.asarray(item)])
        else:
            output.append(item)
    return output


def print_modality_sample(modality_sample: list) -> list[tuple]:
    """Print a `(kind, shape)` summary of a modality sample ('text',
    'modality', or 'modality:{type}' for a (type, array) item) and return
    it."""
    output = []
    for item in modality_sample:
        if isinstance(item, tuple):
            modality_type, item = item
            output.append((f"modality:{modality_type}", tuple(np.shape(item))))
        elif is_int_array(item):
            output.append(("text", tuple(np.shape(item))))
        else:
            output.append(("modality", tuple(np.shape(item))))
    print(output)
    return output


# character-level tokenizer for the modality shape meta string


def char_tokenize(text: str, offset: int = 0) -> np.ndarray:
    return np.array([ord(c) for c in text], dtype=np.int32) + offset


def decode_chars(t, offset: int = 0) -> str:
    byte_list = np.clip(np.asarray(t) - offset, 0, 127).tolist()
    return "".join(map(chr, byte_list))


def tokens_since_rightmost_id(t, rightmost_id: int) -> np.ndarray:
    """The tokens strictly after the last occurrence of `rightmost_id`
    (empty when it does not occur)."""
    t = np.asarray(t)
    (hits,) = np.nonzero(t == rightmost_id)
    if hits.size == 0:
        return t[0:0]
    return t[hits[-1] + 1 :]
