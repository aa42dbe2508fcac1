#!/usr/bin/env python3
"""Drive the PyTorch port (`transfusion_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build: compile every CUDA kernel of the serving path from
     `transfusion_tpu_torch/csrc/` (one nvcc per source, in parallel);
     print the card's name and power limit;
  2. kernels vs plain: each kernel against its plain PyTorch version on the
     same inputs, at synthetic shapes around the serving path's (bf16 within
     2e-2, float32 within 1e-4 max abs error; every row's max error also
     within 0.08 (bf16) / 1e-3 (float32) of that row's RMS), with kernel
     ms, plain ms, the card's bound, and the SDPA time (no softcap, so a
     yardstick only);
  3. reference: a small float32 model on the card (kernels) against the
     same weights on the CPU (plain versions): prefill logits, greedy
     tokens and sampled latents must agree;
  4. serving: the bench model at full width (dim 384, depth 8, 8x64 heads,
     bf16, seeded weights) through `generate_text_batch` (8 ragged prompts,
     128 new tokens, greedy; bf16 and int8 KV) and `sample(cache_kv=True)`
     with CFG. Each path's warm-up captures the tensors of one prefill and
     one decode call, and each kernel is held against its plain version on
     them (as in phase 2). Then the path runs with the launch counters set
     to 0 and must launch both kernels;
  5. the `kernels` line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without a CUDA device, or outside a checkout of the repository, it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

BENCH_CFG = dict(
    num_text_tokens=256, dim_latent=32, modality_default_shape=(14, 14),
    transformer=dict(dim=384, depth=8, dim_head=64, heads=8, attn_impl="flash"),
)
SMALL_CFG = dict(
    num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4), pad_multiple=16,
    transformer=dict(dim=64, depth=2, dim_head=32, heads=2, attn_impl="flash"),
)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# max row error over the reference row's RMS: output rounding alone gives up
# to one bf16 ulp (2^-7 relative) of the row's largest element, ~3x its RMS
ROW_REL_TOL = {"bfloat16": 0.08, "float32": 1e-3}


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=10):
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------


def compare(torch, out, ref):
    """(max abs error, max over rows of the row's max abs error / the
    reference row's RMS). A row whose reference is all zero (it sees no
    key) must come out exactly zero."""
    diff = (out.float() - ref.float()).abs()
    row_err = diff.amax(-1)
    row_rms = ref.float().pow(2).mean(-1).sqrt()
    live = row_rms > 0
    rel = (row_err[live] / row_rms[live]).max().item() if live.any() else 0.0
    if bool((row_err[~live] > 0).any()):
        rel = float("inf")
    return diff.max().item(), rel


def check_flash(torch, mods, a, iters=10):
    """Kernel 1 against its plain version on the arguments `a` of one
    flash_attention call (q, k, v, spans, causal, softcap, offsets, lse)."""
    fa = mods["flash"]
    q, k, v, spans = a["q"], a["k"], a["v"], a["spans"]
    q_off, kv_off = int(a["q_offset"] or 0), int(a["kv_offset"] or 0)
    lse = bool(a["return_lse"])
    kw = dict(spans=spans, causal=a["causal"], softcap=a["softcap"], q_offset=q_off,
              kv_offset=kv_off, return_lse=lse)
    out = fa.flash_attention(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, spans, a["softcap"], q_off, kv_off)
    torch.cuda.synchronize()
    if lse:
        out, out_lse = out
    err, rel = compare(torch, out, ref)
    if lse:
        live = ref_lse > -1e29
        err = max(err, (out_lse[live] - ref_lse[live]).abs().max().item() if live.any() else 0.0)
        require(bool((out_lse[~live] < -1e29).all()), "flash lse of a fully masked row")
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, spans, a["softcap"], q_off, kv_off),
                    max(2, iters // 3))
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    rows = torch.arange(nq, device="cuda") + q_off
    cols = torch.arange(nkv, device="cuda") + kv_off
    mask = mods["spans"].span_allowed(rows, cols, spans)  # [b|1, nq, nkv]
    visible = int(mask.sum().item()) * (b // mask.shape[0])
    itemsize = q.element_size()
    nbytes = 2 * b * h * (nq + nkv) * d * itemsize + (b * h * nq * 4 if lse else 0)
    if spans is not None:
        nbytes += spans.numel() * 4
    bnd, by = bound_ms(nbytes, 4 * h * d * visible, str(q.dtype).split(".")[-1])
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None]), iters)
    return dict(err=err, row_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                sdpa_no_softcap_ms=lib)


def check_decode(torch, mods, a, iters=20):
    """Kernel 2 against its plain version on the arguments `a` of one
    decode_attention call (q, k, v, bias, k_scale, v_scale, softcap, lens)."""
    da = mods["decode"]
    args = tuple(a[n] for n in ("q", "k", "v", "bias", "k_scale", "v_scale", "softcap", "lens"))
    q, k, lens = a["q"], a["k"], a["lens"]
    out = da.decode_attention(*args)
    ref = da.decode_attention_plain(*args).to(q.dtype)
    torch.cuda.synchronize()
    err, rel = compare(torch, out, ref)
    ms = time_ms(lambda: da.decode_attention(*args), iters)
    plain = time_ms(lambda: da.decode_attention_plain(*args), max(2, iters // 4))
    b, h, nq, d = q.shape
    int8 = a["k_scale"] is not None
    slots = int(lens.sum().item()) if lens is not None else b * k.shape[2]
    per_slot = h * d * k.element_size() * 2 + (h * 8 if int8 else 0) + 4  # K, V, scales, bias
    nbytes = slots * per_slot + 2 * b * h * nq * d * q.element_size() + 4 * b
    kind = "int8" if int8 else str(k.dtype).split(".")[-1]
    bnd, by = bound_ms(nbytes, 4 * h * nq * d * slots, kind)
    return dict(err=err, row_rel_err=rel, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)


def flash_case(torch, mods, b, h, n, d, dtype, spans, q_offset=0, kv_offset=0, lse=False,
               iters=10):
    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    return check_flash(torch, mods, dict(
        q=q, k=k, v=v, spans=spans, causal=True, softcap=50.0, q_offset=q_offset,
        kv_offset=kv_offset, return_lse=lse), iters)


def decode_case(torch, mods, b, h, nq, cap, d, dtype, lens_list, int8, iters=20):
    g = torch.Generator(device="cuda").manual_seed(nq + cap)
    q = torch.randn(b, h, nq, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(b, h, cap, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    valid = torch.arange(cap, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e30).float().contiguous()
    ks = vs = None
    if int8:
        k, ks = mods["layers"]._quantize_rows(k)
        v, vs = mods["layers"]._quantize_rows(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    return check_decode(torch, mods, dict(
        q=q, k=k, v=v, bias=bias, k_scale=ks, v_scale=vs, softcap=50.0, lens=lens), iters)


RESULTS = {"flash_fwd": [], "decode_attn": []}


def record(name, shape, res, dtype):
    """Log one kernel-vs-plain result and hold it to the dtype's limits:
    max abs error, and max row error over the reference row's RMS (so a
    kernel that drops part of a long row fails even where |out| is small)."""
    kind = str(dtype).split(".")[-1]
    log(json.dumps({"kernel": name, "shape": shape, **res}))
    require(res["err"] <= TOL[kind], f"{name} {shape}: max abs err {res['err']} > {TOL[kind]}")
    require(res["row_rel_err"] <= ROW_REL_TOL[kind],
            f"{name} {shape}: row err / row RMS {res['row_rel_err']} > {ROW_REL_TOL[kind]}")
    RESULTS[name].append(res)
    return res


def phase_kernels(torch, mods):
    spans_of = lambda b, ls: torch.tensor(  # noqa: E731 — [text][image]... layouts
        [[[0, off, ln] for off, ln in ls]] * b, dtype=torch.int32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    for n, spans in ((256, [(33, 196)]), (1024, [(10, 196), (400, 196)]),
                     (4096, [(10, 196), (1500, 196), (3000, 196)])):
        record("flash_fwd", f"b2 h8 n{n} d64 bf16 spans{len(spans)}",
               flash_case(torch, mods, 2, 8, n, 64, bf16, spans_of(2, spans)), bf16)
    record("flash_fwd", "b2 h8 n1024 d64 bf16 q_off=512 kv_off=256 lse",
           flash_case(torch, mods, 2, 8, 1024, 64, bf16, spans_of(2, [(700, 196)]),
                      q_offset=512, kv_offset=256, lse=True), bf16)
    record("flash_fwd", "b2 h8 n1000 d64 f32 spans1",
           flash_case(torch, mods, 2, 8, 1000, 64, f32, spans_of(2, [(33, 196)]), iters=3), f32)

    lens4 = [8192, 5000, 1200, 37]
    for nq in (1, 196):
        for int8 in (False, True):
            record("decode_attn", f"b4 h8 nq{nq} cap8192 d64 bf16{' int8' if int8 else ''}",
                   decode_case(torch, mods, 4, 8, nq, 8192, 64, bf16, lens4, int8), bf16)
    record("decode_attn", "b4 h8 nq196 cap8192 d64 f32",
           decode_case(torch, mods, 4, 8, 196, 8192, 64, f32, lens4, False, iters=3), f32)
    # long-context text serving: where the kernel loses to its plain version
    lens8 = [8192 - 37 * i for i in range(8)]
    for int8 in (False, True):
        record("decode_attn", f"long context: b8 h8 nq1 cap8192 d64 bf16{' int8' if int8 else ''}",
               decode_case(torch, mods, 8, 8, 1, 8192, 64, bf16, lens8, int8), bf16)


# ---------------------------------------------------------------------------
# phase 3: small float32 model, card vs CPU
# ---------------------------------------------------------------------------


def phase_reference(torch, Transfusion):
    import numpy as np

    gpu = Transfusion(device="cuda", dtype=torch.float32, seed=3, **SMALL_CFG)
    cpu = Transfusion(device="cpu", dtype=torch.float32, seed=3, **SMALL_CFG)
    cpu.core.load_state_dict({k: v.cpu() for k, v in gpu.core.state_dict().items()})
    prompts = [np.arange(1, n + 1) % 16 for n in (5, 40, 130)]
    toks = [m.generate_text_batch(prompts, max_new_tokens=12, temperature=0.0).cpu()
            for m in (gpu, cpu)]
    require(torch.equal(toks[0], toks[1]), f"greedy tokens card {toks[0]} vs cpu {toks[1]}")

    packed = gpu.pack([[np.asarray([gpu.sos_id, 3, 4, 5, 6], np.int32)]],
                      wrap_sos_eos=False, add_meta=False)
    last = [m._prefill_impl(packed, cap=128)[0].cpu() for m in (gpu, cpu)]
    err = (last[0] - last[1]).abs().max().item()
    require(err <= 1e-4, f"prefill logits card vs cpu: {err}")

    noise = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    kw = dict(prompt=[np.asarray([gpu.som_ids[0]])], max_length=20, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0, cache_kv=True)
    lat = [next(o[1] for o in m.sample(**kw) if isinstance(o, tuple)) for m in (gpu, cpu)]
    lat_err = float(np.abs(lat[0] - lat[1]).max())
    require(lat_err <= 1e-3, f"sampled latents card vs cpu: {lat_err}")
    log(json.dumps({"reference": "small f32 model, card vs cpu", "tokens_equal": True,
                    "prefill_logits_err": err, "latents_err": lat_err}))


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------------


def serving_lengths():
    return [37, 160, 283, 406, 530, 653, 776, 900]


def counted(mods, fn):
    """Run fn with both launch counters set to 0; returns (result, counts)."""
    fa, da = mods["flash"].flash_attention, mods["decode"].decode_attention
    fa.launches = da.launches = 0
    out = fn()
    import torch

    torch.cuda.synchronize()
    return out, {"flash_fwd": fa.launches, "decode_attn": da.launches}


@contextlib.contextmanager
def capturing(torch, mods, want):
    """While open, keep a copy of the arguments of the first call the model
    makes to each kernel wrapper (as `models/layers.py` binds it) that
    want[name] accepts. The call itself goes on to the wrapper unchanged."""
    layers, seen, originals = mods["layers"], {}, {}
    for name, attr in (("flash_fwd", "flash_attention"), ("decode_attn", "decode_attention")):
        orig = originals[attr] = getattr(layers, attr)

        def spy(*args, _orig=orig, _sig=inspect.signature(orig), _name=name, **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            if _name not in seen and want[_name](bound.arguments):
                seen[_name] = {k: x.clone() if isinstance(x, torch.Tensor) else x
                               for k, x in bound.arguments.items()}
            return _orig(*args, **kw)

        setattr(layers, attr, spy)
    try:
        yield seen
    finally:
        for attr, orig in originals.items():
            setattr(layers, attr, orig)


def bias_is_prefix(bias):
    """True when every row's valid slots (bias 0) are a prefix of the cache."""
    valid = bias > -1e29
    return bool((valid.cummin(dim=-1).values == valid).all())


def check_main_path(torch, mods, name, calls, dtype):
    """Hold each kernel against its plain version on the tensors the main
    path gave it (captured from one call of the serving run)."""
    require(set(calls) == set(KERNELS), f"{name}: captured only {sorted(calls)}")
    out = {}
    fa, dc = calls["flash_fwd"], calls["decode_attn"]
    qs = lambda t: "x".join(map(str, t.shape))  # noqa: E731
    out["flash_fwd"] = record("flash_fwd", f"main path, {name}: prefill q {qs(fa['q'])} "
                              f"spans {'none' if fa['spans'] is None else qs(fa['spans'])}",
                              check_flash(torch, mods, fa), dtype)
    kv = "int8" if dc["k_scale"] is not None else str(dc["k"].dtype).split(".")[-1]
    prefix = "prefix" if bias_is_prefix(dc["bias"]) else "non-prefix"
    out["decode_attn"] = record("decode_attn", f"main path, {name}: q {qs(dc['q'])} "
                                f"cache {qs(dc['k'])} {kv}, {prefix} bias, "
                                f"lens {dc['lens'].tolist()}",
                                check_decode(torch, mods, dc), dtype)
    return out


def phase_serving(torch, Transfusion, mods):
    """Each path: a warm-up run that also captures one call of each kernel
    (checked against the plain version at those tensors), then the counted,
    timed run. Returns (launch totals, main-path kernel results)."""
    import numpy as np

    model = Transfusion(device="cuda", dtype=torch.bfloat16, seed=0, **BENCH_CFG)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n) for n in serving_lengths()]
    b, new = len(prompts), 128
    totals = {"flash_fwd": 0, "decode_attn": 0}
    report, main = {}, {}

    for name, quant in (("generate_text_batch bf16 KV", False),
                        ("generate_text_batch int8 KV", True)):
        run = lambda k: model.generate_text_batch(  # noqa: E731
            prompts, max_new_tokens=k, temperature=0.0, kv_quantize=quant)
        # warm-up; its cache has the timed run's capacity (the width 1024
        # plus 2 or 128 new tokens both round up to 1152)
        with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                     "decode_attn": lambda a: True}) as calls:
            run(2)
        torch.cuda.synchronize()
        require(calls["decode_attn"]["k"].shape[2] == 1152, f"{name}: warm-up cache capacity")
        main[name] = check_main_path(torch, mods, name, calls, torch.bfloat16)
        t0 = time.perf_counter()
        run(1)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, counts = counted(mods, lambda: run(new))
        t_all = time.perf_counter() - t0
        toks = toks.cpu()
        require(tuple(toks.shape) == (b, new), f"{name}: tokens shape {tuple(toks.shape)}")
        require(bool(((toks >= 0) & (toks < 256)).all()), f"{name}: non-text token")
        require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0,
                f"{name}: kernel launches {counts}")
        for k in totals:
            totals[k] += counts[k]
        report[name] = dict(
            seconds=t_all, tokens_per_s=b * new / t_all,
            ms_per_decode_step=(t_all - t_prefill) / (new - 1) * 1e3,
            prefill_plus_one_step_ms=t_prefill * 1e3, launches=counts,
        )
        log(json.dumps({"serving": name, **report[name]}))

    name = "sample cache_kv cfg 3.0"
    prompt = [np.asarray(list(rng.integers(0, 256, size=24)) + [model.som_ids[0]], np.int32)]
    kw = dict(prompt=prompt, max_length=196, text_temperature=0.0, cache_kv=True,
              kv_quantize=False, cfg_scale=3.0, modality_steps=16,
              fixed_modality_shape=(14, 14), generator=torch.Generator("cuda").manual_seed(0))
    # warm-up (2 ODE steps, the same cache); captures an ODE evaluation over
    # the 196 latent rows
    with capturing(torch, mods, {"flash_fwd": lambda a: True,
                                 "decode_attn": lambda a: a["q"].shape[2] == 196}) as calls:
        model.sample(**{**kw, "modality_steps": 2})
    torch.cuda.synchronize()
    main[name] = check_main_path(torch, mods, name, calls, torch.bfloat16)
    t0 = time.perf_counter()
    items, counts = counted(mods, lambda: model.sample(**kw))
    t_img = time.perf_counter() - t0
    lats = [it[1] for it in items if isinstance(it, tuple)]
    require(len(lats) >= 1, "sample: no modality was sampled")
    require(all(l.shape == (14, 14, 32) and np.isfinite(l).all() for l in lats),
            "sample: latents of the wrong shape or not finite")
    require(counts["flash_fwd"] > 0 and counts["decode_attn"] > 0,
            f"sample: kernel launches {counts}")
    for k in totals:
        totals[k] += counts[k]
    report[name] = dict(seconds=t_img, images=len(lats), s_per_image=t_img / len(lats),
                        launches=counts)
    log(json.dumps({"serving": name, **report[name]}))
    return totals, main


# ---------------------------------------------------------------------------


KERNELS = {
    "flash_fwd": dict(
        source="transfusion_tpu_torch/csrc/flash_fwd.cu",
        replaces="transfusion_tpu/ops/pallas_attn_kernel.py:345",
    ),
    "decode_attn": dict(
        source="transfusion_tpu_torch/csrc/decode_attn.cu",
        replaces="transfusion_tpu/ops/pallas_decode_kernel.py:164",
    ),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from transfusion_tpu_torch import Transfusion
        from transfusion_tpu_torch.models import layers
        from transfusion_tpu_torch.ops import _build, decode_attn, flash_attn, spans
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    mods = dict(flash=flash_attn, decode=decode_attn, layers=layers, spans=spans)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)

    t0 = time.perf_counter()
    _build.build_all()
    log(json.dumps({"build_seconds": time.perf_counter() - t0}))
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.ptxas_log(name).splitlines() if "registers" in ln]
        log(f"ptxas {name}: {regs}")

    phase_kernels(torch, mods)
    phase_reference(torch, Transfusion)
    launches, main_path = phase_serving(torch, Transfusion, mods)

    # the kernels line times each kernel on the tensors captured from the
    # text path with bf16 KV
    text = main_path["generate_text_batch bf16 KV"]
    kernels = []
    for name, meta in KERNELS.items():
        require(launches[name] > 0, f"{name} was not launched on the serving path")
        m = text[name]
        kernels.append(dict(
            name=name, route="cuda", **meta, launches=launches[name],
            max_abs_err=max(r["err"] for r in RESULTS[name]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None,
        ))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
