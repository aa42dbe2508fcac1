"""Batched multimodal sampling (counterpart of
`transfusion_tpu/models/sample_batch.py`): R `sample(cache_kv=True)` state
machines over one pool of device state.

  * one KV cache with R rows (2R with CFG: rows [0, R) are the conditional
    streams, rows [R, 2R) their unconditional twins, the incremental
    batch-2 CFG layout of `_sample_cached` widened to the pool);
  * one batched prefill over every prompt (ragged rows, per-row cache
    offsets: the flash kernel over the packed chunk);
  * text: chunks of up to `text_chunk` batched decode steps (the decode
    kernel, one query row per cache row). A chunk is a Python loop on device
    tensors: rows stop on som/eos/budget through `torch.where`, and the
    emitted tokens and emit mask come back in one [R, 2k] copy, one host
    fetch per chunk. Rows in other phases ride along inert: their new slot
    is masked invalid and their write index pinned, so the next write
    overwrites it;
  * modality segments grouped by (modality type, shape): each group's tail
    ODE is one batched integration over all pool rows (the decode kernel
    with the segment's rows as queries); non-member rows compute finite
    garbage that is masked invalid and dropped.

Request-level behaviour (transition detection, shape meta parsing, eos,
max_length) replicates `Transfusion._sample_cached`, so at temperature 0
with pinned modality noise each request's output equals its solo
`sample(cache_kv=True)`.

Randomness: the JAX package folds (base key, request, count) into one key
per draw, so a request's draws do not depend on its co-tenants. Torch
generators cannot fold in; the port keeps the same contract with streams of
its own: every draw comes from a `torch.Generator` seeded from (seed,
stream, request index, count) alone (`_draw_seed`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from transfusion_tpu_torch.data.packing import to_channel_last, to_user_layout
from transfusion_tpu_torch.models.transformer import cache_mark_valid
from transfusion_tpu_torch.ops.flow import min_p_filter
from transfusion_tpu_torch.ops.norms import safe_log
from transfusion_tpu_torch.ops.odeint import odeint, odeint_adaptive_rows

_TEXT_STREAM, _NOISE_STREAM = 0, 1


def _round_up(n, m):
    return -(-int(n) // m) * m


def _width_bucket_pack(model, batch_items, cap=None):
    """Pack to the next power-of-two multiple of pad_multiple (the JAX
    `bucket_pack`, `transfusion.py:1888-1899`): the packed width, and so
    the flash envelope a call takes, moves in O(log length) steps. A
    prefill into a cache of `cap` slots packs at most `cap` wide (the JAX
    `sample_batch` fails on a bucket wider than its cache)."""
    packed = model.pack(batch_items, wrap_sos_eos=False, add_meta=False)
    L = packed.text.shape[1]
    mult = model.pad_multiple
    chunks = max(1, -(-L // mult))
    bucket = mult * (1 << (chunks - 1).bit_length())
    if cap is not None:
        bucket = max(min(bucket, cap), L)
    if bucket != L:
        packed = model.pack(batch_items, wrap_sos_eos=False, add_meta=False,
                            pad_multiple=bucket)
    return packed


def _seq_stats(model, items):
    """(token count, rotary collapse) of an item list: a latent whose
    sequence shape holds L positions takes L sequence rows and one rotary
    position."""
    tok_count, collapse = 0, 0
    for it in items:
        if isinstance(it, tuple):
            mc = model.modalities[it[0]]
            lat = to_channel_last(np.asarray(it[1]), mc.channel_first_latent)
            L = model.seq_len_for(it[0], lat.shape[:-1])
            tok_count += L
            collapse += L - 1
        else:
            tok_count += len(it)
    return tok_count, collapse


def _uncond_of(model, items):
    """Unconditional twin: every text id (specials and meta included)
    nulled, modalities kept."""
    return [
        np.where(np.asarray(it) >= 0, model.null_text_id, it) if not isinstance(it, tuple)
        else it
        for it in items
    ]


class _Req:
    __slots__ = (
        "items", "tok_count", "collapse", "slots_used", "pending", "parked", "mid",
        "shape", "curr_length", "done", "n_sampled", "n_segments",
    )

    def __init__(self, items, tok_count, collapse):
        self.items = items
        self.tok_count = tok_count
        self.collapse = collapse
        self.slots_used = 0
        self.pending: Optional[int] = None
        self.parked = False
        self.mid: Optional[int] = None
        self.shape: Optional[tuple] = None
        self.curr_length = 0
        self.done = False
        self.n_sampled = 0
        self.n_segments = 0


def _transition(model, r: _Req, fixed_modality_shape=None):
    """Park the request if its last text token is a som trigger (the solo
    loop's transition)."""
    trigger = model._modality_trigger(r.items, fixed_modality_shape)
    if trigger is not None:
        r.mid, r.shape = trigger
        r.parked = True


def _append_tok(r: _Req, tok: int):
    last = r.items[-1]
    if isinstance(last, tuple):
        r.items.append(np.asarray([tok], np.int32))
    else:
        r.items[-1] = np.concatenate([last, np.asarray([tok], np.int32)])


def _consume(model, r: _Req, tok: int, fixed_modality_shape=None):
    """A freshly sampled token of a text-phase request (the solo loop's
    text branch)."""
    r.pending = tok
    r.n_sampled += 1
    _append_tok(r, tok)
    r.curr_length += 1
    if tok == model.eos_id:
        r.done = True
        return
    _transition(model, r, fixed_modality_shape)


def _draw_seed(seed: int, stream: int, request: int, count: int) -> int:
    """The seed of one draw: a function of (seed, stream, request, count)
    alone."""
    state = np.random.SeedSequence([seed, stream, request, count]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _gumbel_rows(seed: int, keys, vocab: int, device, stream: int = _TEXT_STREAM):
    """Gumbel noise Float32[len(keys), vocab]; row j from `stream` at
    (request, count) = keys[j], or zeros where keys[j] is None (a row whose
    draw is discarded)."""
    u = torch.full((len(keys), vocab), 0.5, device=device)
    for j, key in enumerate(keys):
        if key is not None:
            g = torch.Generator(device=device).manual_seed(_draw_seed(seed, stream, *key))
            u[j].uniform_(generator=g)
    noise = -safe_log(-safe_log(u.clamp_min(1e-20)))
    if any(key is None for key in keys):
        drawn = torch.tensor([key is not None for key in keys], device=device)
        noise = torch.where(drawn[:, None], noise, 0.0)
    return noise


def _fetch(t):
    """The host loop's one way of reading the device: a blocking copy."""
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------


def _pick_impl(model, last_logits, gumbel, *, temperature, min_p):
    """One token per row from logits [R, vocab] (min-p over the whole
    vocabulary, so som and eos can be drawn); gumbel Float[R, vocab] or
    None at temperature 0."""
    filtered = min_p_filter(last_logits.float(), min_p)
    if temperature == 0.0:
        return filtered.argmax(dim=-1)
    return (filtered / temperature + gumbel).argmax(dim=-1)


def _chunk_tick_impl(model, cache, toks0, pos0, active0, rem, gumbel, *, temperature,
                     min_p, R, k, stop_ids):
    """k batched text steps with per-row stopping, all on the device (the
    JAX `_chunk_tick_impl`'s `lax.scan`, `sample_batch.py:175-255`).

    At step j each active cond row streams its pending token (its uncond
    twin streams null at the same position), samples the next token from
    the fresh logits with its noise gumbel[j] (drawn for (request, count)),
    emits it, and stops on a stop id or when its emit budget `rem` is spent
    (parked rows flush their som with rem 1). Inactive rows write their
    slot at the pinned index, masked invalid. Nothing here reads the device
    from the host. Returns (payload Int64[R, 2k]: tokens then emit mask,
    cache)."""
    rows = pos0.shape[0]
    dev = toks0.device
    null_row = torch.full((R,), model.null_text_id, dtype=toks0.dtype, device=dev)
    pending, pos, act_c = toks0, pos0, active0
    cnt = torch.zeros((R,), dtype=rem.dtype, device=dev)
    toks_out, emits_out = [], []
    for j in range(k):
        active = torch.cat([act_c, act_c]) if rows == 2 * R else act_c
        toks = torch.where(act_c, pending, 0)
        toks_rows = torch.cat([toks, null_row]) if rows == 2 * R else toks
        old_idx = cache["idx"]
        cache = cache_mark_valid(cache, active[:, None])
        logits, cache = model.core.decode_text_step(toks_rows[:, None], pos[:, None], cache)
        cache = {**cache, "idx": torch.where(active, cache["idx"], old_idx)}
        nxt = _pick_impl(model, logits[:R, -1], None if gumbel is None else gumbel[j],
                         temperature=temperature, min_p=min_p)
        toks_out.append(nxt)
        emits_out.append(act_c)
        pending = torch.where(act_c, nxt, pending)
        cnt = cnt + act_c.to(cnt.dtype)
        stop = (cnt >= rem) | (nxt[:, None] == stop_ids[None, :]).any(dim=-1)
        act_c = act_c & ~stop
        pos = pos + active.to(pos.dtype)
    payload = torch.cat([torch.stack(toks_out, 1), torch.stack(emits_out, 1).long()], dim=1)
    return payload, cache


def _ode_impl(model, cache, noise, p0, member, cfg_scale, *, mid, L, steps, use_cfg, R):
    """Batched tail-only ODE over the pool cache (JAX `_ode_impl`,
    `sample_batch.py:258-296`). noise Float[R, *shape, d] (zeros for
    non-members); p0 Int[rows] per-row positions; member Bool[rows]. Each
    flow evaluation writes every row's segment into the slots after its
    index, masked valid for members only; the returned cache is dropped, so
    nothing moves. Non-member rows attend to their own history and come out
    finite."""
    rows = p0.shape[0]
    rotary = p0[:, None].expand(rows, L)
    cc = cache_mark_valid(cache, member[:, None].expand(rows, L))

    def flow(t, y):
        y_rows = torch.cat([y, y]) if rows == 2 * R else y
        t_rows = t
        if t.ndim == 1 and rows == 2 * R:
            t_rows = torch.cat([t, t])  # uncond twins share their cond row's clock
        f, _ = model.core.decode_modality_rows(y_rows, t_rows, rotary, cc, mid)
        if use_cfg:
            return f[R:] + cfg_scale * (f[:R] - f[R:])
        return f

    if model.odeint_method == "adaptive":
        # per-row step control: a request's trajectory must not depend on the
        # rows it is pooled with
        return odeint_adaptive_rows(flow, noise, 0.0, 1.0)
    grid = torch.linspace(0.0, 1.0, steps, dtype=torch.float32)
    return odeint(flow, noise, grid, method=model.odeint_method)


def _append_impl(model, cache, y, p0, member, *, mid, L, R):
    """Write the sampled segment into the member rows' caches (conditioned
    as clean, t = 1); non-member rows' writes stay invalid and their index
    pinned."""
    rows = p0.shape[0]
    old_idx = cache["idx"]
    cache = cache_mark_valid(cache, member[:, None].expand(rows, L))
    rotary = p0[:, None].expand(rows, L)
    y_rows = torch.cat([y, y]) if rows == 2 * R else y
    _, cache = model.core.decode_modality_rows(y_rows, 1.0, rotary, cache, mid)
    return {**cache, "idx": torch.where(member, cache["idx"], old_idx)}


# ---------------------------------------------------------------------------
# the host state machine
# ---------------------------------------------------------------------------


def sample_batch(model, prompts, seed: int = 0, max_length=2048,
                 text_temperature: float = 1.5, text_min_p: float = 0.1,
                 fixed_modality_shape: Optional[tuple] = None, init_modality_noise=None,
                 modality_steps: int = 16, cfg_scale: float = 3.0,
                 kv_quantize: Optional[bool] = None,
                 return_unprocessed_modalities: bool = False, text_chunk: int = 32):
    """The batched equivalent of `model.sample(cache_kv=True, ...)` over R
    prompts (the JAX `sample_batch`, `sample_batch.py:323-601`). Returns one
    item list per request, each modality decoded when it has a decoder
    (unless return_unprocessed_modalities).

    max_length is one budget for all, or one per prompt: each row stops and
    retires on its own budget. `seed` names the draws: text tokens at
    temperature > 0 and modality noise (unless init_modality_noise pins
    it) come from per-request streams of (seed, request, count)."""
    if not prompts:
        raise ValueError("sample_batch needs at least one prompt")
    if model.num_text_tokens <= 0:
        raise ValueError("sample_batch needs a text vocabulary; use generate_modality_only "
                         "for pure-modality models (it is already batched)")
    dev = model.device
    R = len(prompts)
    if isinstance(max_length, (int, float, np.integer)):
        budgets = [int(max_length)] * R
    else:
        budgets = [int(v) for v in max_length]
        if len(budgets) != R:
            raise ValueError(f"{len(budgets)} budgets for {R} prompts")
    use_cfg = cfg_scale != 1.0
    rows = 2 * R if use_cfg else R
    temperature, min_p = float(text_temperature), float(text_min_p)
    # in-chunk stop set: modality triggers and eos (the budget rides apart)
    stop_ids = torch.as_tensor([*model.som_ids, model.eos_id], dtype=torch.int64, device=dev)

    reqs = []
    for p in prompts:
        items = model._prompt_to_items(p)
        reqs.append(_Req(items, *_seq_stats(model, items)))

    cap = _round_up(max(r.tok_count + b for r, b in zip(reqs, budgets)) + 256 + 2, 128)
    quantize = model._plan(cap, rows, kv_quantize).kv_quantize

    def prefill(this_cap):
        batch_items = [r.items for r in reqs]
        if use_cfg:
            batch_items += [_uncond_of(model, r.items) for r in reqs]
        packed = _width_bucket_pack(model, batch_items, this_cap)
        last_logits, cache = model._prefill_impl(packed, cap=this_cap, quantize=quantize)
        lengths = np.asarray(packed.lengths, np.int64)
        # per-row offsets: every row continues at its own length
        cache = {**cache, "idx": torch.as_tensor(lengths, dtype=torch.int32, device=dev)}
        for i, r in enumerate(reqs):
            r.slots_used = int(lengths[i])
            r.pending = None
        return last_logits, cache

    last_logits, cache = prefill(cap)
    for r in reqs:
        _transition(model, r, fixed_modality_shape)

    def live(r):
        return not r.done

    def retire_overlong():
        for r, b in zip(reqs, budgets):
            if live(r) and r.curr_length > b:
                r.done = True

    def gumbel(keys):
        return None if temperature == 0.0 else _gumbel_rows(seed, keys, model.vocab_size, dev)

    while any(live(r) for r in reqs):
        retire_overlong()

        # pick: text-phase requests with nothing pending (after a prefill)
        # sample straight from the stored logits
        need_pick = [i for i, r in enumerate(reqs) if live(r) and not r.parked
                     and r.pending is None]
        if need_pick:
            picks = _fetch(_pick_impl(
                model, last_logits[:R], gumbel([(i, r.n_sampled) for i, r in enumerate(reqs)]),
                temperature=temperature, min_p=min_p))
            for i in need_pick:
                _consume(model, reqs[i], int(picks[i]), fixed_modality_shape)
            retire_overlong()

        # chunked text decode: stream every pending token and go on decoding
        # on the device; rows stop there on som/eos/budget (parked rows flush
        # their som with an emit budget of 1)
        stream = [i for i, r in enumerate(reqs) if live(r) and r.pending is not None]
        if stream:
            toks0 = np.zeros(R, np.int64)
            pos0 = np.zeros(rows, np.int64)
            act0 = np.zeros(R, bool)
            rem = np.zeros(R, np.int64)
            cnt0 = np.zeros(R, np.int64)
            for i in stream:
                r = reqs[i]
                toks0[i] = r.pending
                pos0[i] = r.tok_count - r.collapse
                act0[i] = True
                rem[i] = 1 if (r.parked or r.done) else budgets[i] - r.curr_length + 1
                cnt0[i] = r.n_sampled
                if use_cfg:
                    pos0[R + i] = pos0[i]
            k = 1 << (min(int(max(rem[i] for i in stream)), int(text_chunk)) - 1).bit_length()
            noise_j = gumbel([(i, int(cnt0[i]) + j) for j in range(k) for i in range(R)])
            payload, cache = _chunk_tick_impl(
                model, cache, torch.as_tensor(toks0, device=dev), torch.as_tensor(pos0, device=dev),
                torch.as_tensor(act0, device=dev), torch.as_tensor(rem, device=dev),
                None if noise_j is None else noise_j.view(k, R, -1),
                temperature=temperature, min_p=min_p, R=R, k=k, stop_ids=stop_ids)
            payload = _fetch(payload)  # one host fetch per chunk
            toks_e, emits = payload[:, :k], payload[:, k:].astype(bool)
            for i in stream:
                r = reqs[i]
                m = int(emits[i].sum())  # a row is active on a prefix of the chunk
                r.tok_count += m  # one streamed token per active step
                r.slots_used += m
                if r.parked or r.done:
                    r.pending = None  # som flushed / eos never continued
                else:
                    for j in range(m):
                        _consume(model, r, int(toks_e[i, j]), fixed_modality_shape)
                        if r.done or r.parked:
                            break

        # ODE: parked requests grouped by (modality, shape)
        groups = {}
        for i, r in enumerate(reqs):
            if live(r) and r.parked and r.pending is None:
                groups.setdefault((r.mid, r.shape), []).append(i)
        for (mid, spatial), members in groups.items():
            mc = model.modalities[mid]
            L = model.seq_len_for(mid, spatial)

            # every row writes the segment after its index in place (a
            # non-member's write is masked invalid), so the capacity has to
            # hold it for all rows, not only for the members as in the JAX
            # package, whose functional cache update clamps
            if any(r.slots_used + L + 2 > cap for r in reqs):
                # capacity exhausted: rebuild the whole pool at a larger cap
                cap = _round_up(max(r.slots_used for r in reqs) + L + 256, 128)
                for r in reqs:
                    r.tok_count, r.collapse = _seq_stats(model, r.items)
                last_logits, cache = prefill(cap)

            noise = torch.zeros((R, *spatial, mc.dim_latent), device=dev)
            member_mask = np.zeros(rows, bool)
            p0 = np.zeros(rows, np.int64)
            for i, r in enumerate(reqs):
                p0[i] = r.tok_count - r.collapse
                if use_cfg:
                    p0[R + i] = p0[i]
            for i in members:
                r = reqs[i]
                member_mask[i] = True
                if use_cfg:
                    member_mask[R + i] = True
                g = None
                if init_modality_noise is None:
                    g = torch.Generator(device=dev).manual_seed(
                        _draw_seed(seed, _NOISE_STREAM, i, r.n_segments))
                noise[i] = model._segment_noise(init_modality_noise, spatial, mid, g)

            p0_t = torch.as_tensor(p0, device=dev)
            member_t = torch.as_tensor(member_mask, device=dev)
            sampled = _ode_impl(model, cache, noise, p0_t, member_t, float(cfg_scale), mid=mid,
                                L=L, steps=int(modality_steps), use_cfg=use_cfg, R=R)
            cache = _append_impl(model, cache, sampled, p0_t, member_t, mid=mid, L=L, R=R)
            sampled_np = _fetch(sampled)  # one fetch per group

            for i in members:
                r = reqs[i]
                r.items.append((mid, to_user_layout(sampled_np[i], mc.channel_first_latent)))
                r.items.append(np.asarray([model.eom_ids[mid]], np.int32))
                r.tok_count += L
                r.collapse += L - 1
                r.slots_used += L
                r.curr_length += L
                r.n_segments += 1
                r.pending = model.eom_ids[mid]  # streamed by the next chunk
                r.parked = False
                r.mid = None
                r.shape = None

    if return_unprocessed_modalities:
        return [r.items for r in reqs]
    return [model.decode_modalities(r.items) for r in reqs]
