"""PyTorch port: the rounding budget of the bf16 backward kernel, on the CPU.

The bf16 backward (`csrc/flash_bwd.cu`) rounds p and ds to bf16 before the
dv/dk/dq products and applies the d^-1/2 scale to the float32 sums;
`backward_plain_f32(round_operands=torch.bfloat16)` does the same in
PyTorch. Here, on seeded bf16 inputs at small versions of the main paths'
shapes (rows 6-9 of PERF.md's kernel table, and q/kv offsets with an lse
cotangent and fully masked rows), that arithmetic is held to the card's
checks (`chip_smoke.py`: the largest error within 1e-2 of the gradient's
largest element, every row's largest error within 0.08 of that row's RMS,
a row that is zero in the reference exactly zero) against the unrounded
plain version on bf16 tensors, as the card compares them, and against the
JAX package's gradients on float32 tensors of the same values (its Pallas
kernels in interpret mode, as tests/test_torch_train_attention.py runs
them; in float32 the forward's output is not rounded to bf16, which would
move delta by more than the operand rounding in rows that see few keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_attention import arrays, jax_grads
from transfusion_tpu.ops import pallas_attn_kernel as jflash
from transfusion_tpu_torch.ops import flash_attn, flash_attn_nhd
from transfusion_tpu_torch.ops.rope import rope_angles

torch.set_num_threads(1)

BWD_REL_TOL, ROW_REL_TOL = 1e-2, 0.08  # chip_smoke.py's bf16 limits
BF16 = torch.bfloat16


def bf16_arrays(*shapes, seed):
    """Seeded float32 arrays whose values are bf16 numbers."""
    return [torch.tensor(x).to(BF16).float().numpy() for x in arrays(*shapes, seed=seed)]


def assert_within_card_limits(got, want, what, noise_floor=0.0):
    """noise_floor 0: a row that is zero in `want` must be zero in `got`,
    as chip_smoke.py holds the kernel to the plain version. Against JAX's
    float32 gradients, rows whose RMS is at most noise_floor times the
    largest row RMS are float32 cancellation noise (row 0 sees one key, so
    its ds = dp - delta cancels to ~1e-7 relative), held only by the
    max-error bound."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        diff = np.abs(a - b)
        assert diff.max() <= BWD_REL_TOL * np.abs(b).max(), f"{what} {name}: max err"
        row_err, row_rms = diff.max(-1), np.sqrt((b**2).mean(-1))
        live = row_rms > noise_floor * row_rms.max()
        if noise_floor == 0.0:
            assert (row_err[~live] == 0).all(), f"{what} {name}: a zero row is not zero"
        assert (row_err[live] / row_rms[live]).max() <= ROW_REL_TOL, f"{what} {name}: row err"


def head_major_case(case, monkeypatch):
    """(inputs, torch kwargs, JAX kwargs, block_q) of one head-major case."""
    if case == "row7 d32":  # `_bwd_kernel_batched_heads`
        b, h, n, d, spans = 2, 2, 128, 32, [[[0, 5, 20], [0, 40, 17]]] * 2
        kw = {}
    elif case == "row8 spans4":  # `_bwd_dkv_kernel` + `_bwd_dq_kernel`
        b, h, n, d, spans = 1, 2, 640, 64, [[[0, 40 + 150 * i, 100] for i in range(4)]]
        kw = {}
    elif case == "row9 block_q":  # `_flash_bwd_streamed`, forced by an envelope of 1
        monkeypatch.setattr(jflash, "_MAX_N_TIMES_D_RESIDENT", 1)
        monkeypatch.setattr(jflash, "_MAX_N_TIMES_D_BWD", 1)
        b, h, n, d, spans = 1, 2, 256, 64, [[[0, 40, 100], [0, 150, 64]]]
        kw = {}
    else:  # ring attention's offsets, an lse cotangent, rows 0..95 masked whole
        b, h, n, d, spans = 2, 2, 128, 32, [[[0, 150, 20]], [[0, 100, 0]]]
        kw = dict(q_offset=0, kv_offset=96, return_lse=True)
    spans = np.asarray(spans, np.int32)
    q, k, v, do = bf16_arrays(*[(b, h, n, d)] * 4, seed=21)
    (gl,) = arrays((b, h, n), seed=22) if kw.get("return_lse") else (None,)
    block_q = 64 if case == "row9 block_q" else None
    return (q, k, v, do, gl, spans), kw, block_q


def head_major_grads(q, k, v, do, gl, spans, kw, block_q, dtype):
    """(unrounded plain, rounded) backward of tensors made from q, k, v, do
    in dtype, with o and lse from the plain forward in that dtype (as the
    card's forward gives them), each gradient in dtype."""
    q_off, kv_off = kw.get("q_offset", 0), kw.get("kv_offset", 0)
    qt, kt, vt, dot = (torch.tensor(x).to(dtype) for x in (q, k, v, do))
    sp = torch.tensor(spans)
    out, lse = flash_attn.flash_attention_plain(qt, kt, vt, sp, 50.0, q_off, kv_off, block_q)
    delta = (dot.float() * out.float()).sum(-1) - (0 if gl is None else torch.tensor(gl))
    args = (qt, kt, vt, dot, lse, delta, sp, 50.0, q_off, kv_off, block_q)
    plain = flash_attn.flash_attention_backward_plain(*args)
    rounded = [g.to(dtype) for g in flash_attn.backward_plain_f32(*args, round_operands=BF16)]
    return [[g.float().numpy() for g in gs] for gs in (plain, rounded)]


@pytest.mark.parametrize("case", ["row7 d32", "row8 spans4", "row9 block_q",
                                  "offsets g_lse masked rows"])
def test_head_major_rounding_within_card_limits(case, monkeypatch):
    """On bf16 tensors (o rounded to bf16, as on the card) against the
    unrounded plain version; on float32 tensors of the same values against
    JAX's float32 gradients."""
    (q, k, v, do, gl, spans), kw, block_q = head_major_case(case, monkeypatch)
    plain, rounded = head_major_grads(q, k, v, do, gl, spans, kw, block_q, BF16)
    if gl is not None:  # fully masked rows: dq exactly 0
        assert (rounded[0][:, :, :kw["kv_offset"]] == 0).all()
    assert_within_card_limits(rounded, plain, f"{case} vs plain")
    rounded_f32 = head_major_grads(q, k, v, do, gl, spans, kw, block_q, torch.float32)[1]
    cts = (do,) if gl is None else (do, gl)
    _, g_jax = jax_grads(lambda q, k, v: jflash.flash_attention(
        q, k, v, spans=jnp.asarray(spans), causal=True, **kw), (q, k, v), cts)
    assert_within_card_limits(rounded_f32, g_jax, f"{case} vs JAX", noise_floor=1e-4)


def test_token_major_rope_rounding_within_card_limits():
    """Row 6 (`_bwd_kernel_batched_nhd`): token-major b2 h2 n64 d64, RoPE
    rotated on load and un-rotated on store, 2 spans; bf16 against the
    plain version, float32 against JAX (as the head-major cases)."""
    b, h, n, d = 2, 2, 64, 64
    q, k, v, do = bf16_arrays(*[(b, n, h * d)] * 4, seed=23)
    spans = np.asarray([[[0, 5, 20], [0, 40, 17]], [[0, 10, 0], [0, 30, 25]]], np.int32)
    ang = rope_angles(torch.tensor(np.stack([np.arange(n), np.arange(n) // 2])), d)
    cos, sin = torch.cos(ang), torch.sin(ang)
    sp = torch.tensor(spans)

    def rows(g):  # [b, n, h*d] -> [b, h, n, d]: a row is one head's
        return np.asarray(g, np.float32).reshape(b, n, h, d).transpose(0, 2, 1, 3)

    def grads(dtype):
        qt, kt, vt, dot = (torch.tensor(x).to(dtype) for x in (q, k, v, do))
        out, lse = flash_attn_nhd.flash_attention_nhd_plain(qt, kt, vt, h, cos, sin, sp)
        delta = (dot.float() * out.float()).view(b, n, h, d).sum(-1).transpose(1, 2)
        args = (qt, kt, vt, dot, lse, delta, h, cos, sin, sp)
        plain = flash_attn_nhd.flash_attention_nhd_backward_plain(*args)
        rounded = flash_attn_nhd.flash_attention_nhd_backward_plain(*args, round_operands=BF16)
        return [[rows(g.float()) for g in gs] for gs in (plain, rounded)]

    plain, rounded = grads(BF16)
    assert_within_card_limits(rounded, plain, "row6 vs plain")
    _, g_jax = jax_grads(lambda q, k, v: jflash.flash_attention_nhd(
        q, k, v, h, cos=jnp.asarray(cos.numpy()), sin=jnp.asarray(sin.numpy()),
        spans=jnp.asarray(spans), causal=True), (q, k, v), (do,))
    assert_within_card_limits(grads(torch.float32)[1], [rows(g) for g in g_jax], "row6 vs JAX",
                              noise_floor=1e-4)


def test_rounding_changes_the_sums():
    """The option does round: p and ds in bf16 move dk/dv off the
    unrounded float32 values (by far less than the card's limit)."""
    q, k, v, do = (torch.tensor(x) for x in bf16_arrays(*[(1, 1, 128, 32)] * 4, seed=24))
    out, lse = flash_attn.flash_attention_plain(q, k, v, None)
    delta = (do * out).sum(-1)
    exact = flash_attn.backward_plain_f32(q, k, v, do, lse, delta)
    rounded = flash_attn.backward_plain_f32(q, k, v, do, lse, delta, round_operands=BF16)
    for a, b in zip(rounded[1:], exact[1:]):
        err = (a - b).abs().max().item()
        assert 0 < err <= 1e-2 * b.abs().max().item()
