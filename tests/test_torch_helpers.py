"""PyTorch port: the span helpers (`ops/spans.py` `sort_spans_by_offset`,
`spans_to_token_times`) bit-exact against the JAX package, the host
helpers of `utils/helpers.py` (`print_modality_sample` on numpy and torch
items) against it, and the `TYPECHECK` contract of `utils/typing.py`,
which binds when the module is imported and so is exercised in
subprocesses, as tests/test_typecheck.py does for the JAX package."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.ops import spans as jspans
from transfusion_tpu.utils import helpers as jhelpers
from transfusion_tpu_torch.ops import spans as tspans
from transfusion_tpu_torch.utils import helpers as thelpers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_spans(rng, b=5, m=6, n=40):
    """Spans with empty rows (length 0 and negative), equal offsets and
    zero padding, in a random row order."""
    spans = np.zeros((b, m, 3), np.int32)
    for i in range(b):
        k = rng.integers(0, m + 1)
        offs = np.sort(rng.choice(n - 4, k, replace=False))
        spans[i, :k, 0] = rng.integers(0, 3, k)
        spans[i, :k, 1] = offs
        spans[i, :k, 2] = rng.integers(-1, 4, k)
        spans[i] = spans[i, rng.permutation(m)]
    spans[0, :2, 1] = 7  # a tie between two live rows
    spans[0, :2, 2] = 2
    return spans


def test_spans_helpers_match_jax_bit_exact():
    rng = np.random.default_rng(0)
    for _ in range(5):
        spans = random_spans(rng)
        got, order = tspans.sort_spans_by_offset(torch.tensor(spans))
        want, worder = jspans.sort_spans_by_offset(jnp.asarray(spans))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(order.numpy(), np.asarray(worder))
        live = got[..., 2] > 0  # empty rows last
        assert bool((live.int().diff(dim=-1) <= 0).all())

        # token times: spans that do not overlap, as the packer writes them
        nonover = np.zeros((2, 3, 3), np.int32)
        nonover[0] = [[0, 2, 3], [1, 9, 5], [0, 0, 0]]
        nonover[1] = [[0, 1, 4], [0, 0, -1], [0, 20, 6]]
        times = rng.uniform(size=(2, 3)).astype(np.float32)
        got = tspans.spans_to_token_times(30, torch.tensor(nonover), torch.tensor(times))
        want = jspans.spans_to_token_times(30, jnp.asarray(nonover), jnp.asarray(times))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_helpers_match_jax(capsys):
    items = [np.asarray([1, 2, 3], np.int32), np.zeros((2, 4), np.float32),
             (1, np.zeros((3, 3, 2), np.float32)), np.asarray([4], np.int64)]
    want = jhelpers.print_modality_sample(items)
    assert thelpers.print_modality_sample(items) == want
    as_torch = [torch.tensor(items[0]), torch.tensor(items[1]),
                (1, torch.tensor(items[2][1])), torch.tensor(items[3])]
    assert thelpers.print_modality_sample(as_torch) == want
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == out[2] == str(want)
    f32, i32 = np.zeros(2, np.float32), np.zeros(2, np.int32)
    cases = {"exists": [(None,), (0,)], "identity": [(3, "ignored")], "first": [([5, 6],)],
             "divisible_by": [(6, 3), (7, 2)], "is_float_array": [(f32,), (i32,), ([1.0],)],
             "is_int_array": [(f32,), (i32,), (3,)]}
    for name, calls in cases.items():
        for args in calls:
            assert getattr(thelpers, name)(*args) == getattr(jhelpers, name)(*args), (name, args)
    assert thelpers.is_float_array(torch.zeros(2)) and thelpers.is_int_array(torch.zeros(2).long())
    assert not thelpers.is_int_array(torch.zeros(2, dtype=torch.bool))


_CHILD = textwrap.dedent(r"""
    import sys
    mode = sys.argv[1]
    if mode == "no-jaxtyping":
        sys.modules["jaxtyping"] = None
    import torch
    try:
        from transfusion_tpu_torch.ops.spans import sort_spans_by_offset, spans_to_token_times
    except ImportError as e:
        print("IMPORT-ERROR:", e)
        raise SystemExit(0)
    print("JAXTYPING-LOADED" if "jaxtyping" in sys.modules and sys.modules["jaxtyping"]
          else "JAXTYPING-ABSENT")
    spans = torch.tensor([[[0, 2, 3]]])
    sort_spans_by_offset(spans)
    assert spans_to_token_times(8, spans, torch.zeros((1, 1))).shape == (1, 8)
    failures = 0
    for call in (lambda: sort_spans_by_offset(torch.zeros((1, 1, 4), dtype=torch.int64)),
                 lambda: spans_to_token_times(8, spans, torch.zeros((2, 1))),
                 lambda: spans_to_token_times(8, spans.float(), torch.zeros((1, 1)))):
        try:
            call()
        except Exception:
            failures += 1
    print("FAILURES", failures)
""")


def _child(mode, typecheck):
    env = dict(os.environ, PYTHONPATH=REPO, TYPECHECK=typecheck)
    r = subprocess.run([sys.executable, "-c", _CHILD, mode], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("typecheck", ["1", "true"])
def test_typecheck_on_validates_shapes(typecheck):
    out = _child("plain", typecheck)
    assert "JAXTYPING-LOADED" in out and "FAILURES 3" in out, out


def test_typecheck_off_is_the_identity_and_imports_nothing():
    out = _child("plain", "")
    # the bad calls still fail or broadcast deeper down, but not all three
    # at the decorator: the b-mismatch broadcasts silently
    assert "JAXTYPING-ABSENT" in out and "FAILURES 3" not in out, out
    out = _child("no-jaxtyping", "")
    assert "JAXTYPING-ABSENT" in out, out


def test_typecheck_on_without_jaxtyping_says_so():
    out = _child("no-jaxtyping", "1")
    assert "IMPORT-ERROR" in out and "jaxtyping is not installed" in out, out
