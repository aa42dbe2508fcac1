"""Host-side helpers (counterpart of `transfusion_tpu/utils/helpers.py`,
only what the serving slice uses) plus device resolution for the port's
entry points."""

from __future__ import annotations

import numpy as np
import torch


def default(v, d):
    return v if v is not None else d


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
    return hasattr(t, "dtype") and np.issubdtype(np.asarray(t).dtype, np.integer)


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
