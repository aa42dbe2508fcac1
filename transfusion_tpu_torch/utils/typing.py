"""Runtime shape checks behind the `TYPECHECK` environment variable
(counterpart of `transfusion_tpu/utils/typing.py`).

`@typecheck` is the identity unless `TYPECHECK` is `1` or `true` when this
module is imported. Then it is jaxtyping's `jaxtyped` with beartype or
typeguard as the checker, whichever is importable first (the identity when
neither is), and the annotations `Int[Tensor, "b m 3"]` etc. are
jaxtyping's. jaxtyping is imported only then: modules that annotate write
`from __future__ import annotations`, so with the checks off their
annotations stay strings and `Bool` / `Float` / `Int` are stand-ins that
are never evaluated.
"""

from __future__ import annotations

import os

import torch

Tensor = torch.Tensor


def _identity(fn):
    return fn


class _Unchecked:
    """`Int[Tensor, "..."]` without jaxtyping: the plain tensor type."""

    def __class_getitem__(cls, item):
        return Tensor


def _make_typecheck():
    try:
        import beartype  # type: ignore

        return lambda fn: jaxtyped(typechecker=beartype.beartype)(fn)
    except ImportError:
        pass
    try:
        import typeguard  # type: ignore

        return lambda fn: jaxtyped(typechecker=typeguard.typechecked)(fn)
    except ImportError:
        return _identity


if os.environ.get("TYPECHECK", "").lower() in ("1", "true"):
    try:
        from jaxtyping import Bool, Float, Int, jaxtyped
    except ImportError as e:
        raise ImportError(
            "TYPECHECK is set but jaxtyping is not installed: install jaxtyping for the "
            "shape checks, or unset TYPECHECK") from e
    typecheck = _make_typecheck()
else:
    Bool = Float = Int = _Unchecked
    typecheck = _identity
