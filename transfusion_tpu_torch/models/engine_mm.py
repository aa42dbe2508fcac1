"""Continuous-batching multimodal serving engine (counterpart of
`transfusion_tpu/models/engine_mm.py`).

A pool engine whose requests are whole `sample(cache_kv=True)` calls (AR
text, [som]-triggered flow-ODE image segments, shape meta, CFG), admitted
into free slots as they arrive and retired the moment they finish. It
drives the device functions of `models/sample_batch.py` (`_pick_impl`,
`_chunk_tick_impl`, `_ode_impl`, `_append_impl`) and the host state
machine's `_consume` / `_transition`:

  * one pool cache of `max_requests` slots (rows [0, R) the conditional
    streams; with CFG, rows [R, 2R) their unconditional twins);
  * admission: queued requests pair with free slots, grouped by prompt-width
    bucket (and split into power-of-two groups); each group's cond and
    uncond prompts prefill as one rectangle (`Transfusion._prefill_impl`,
    the flash kernel) and are copied into the pool (`index_copy_` on the
    row dimension);
  * text: every text-phase slot advances in one chunk (`_chunk_tick_impl`,
    the decode kernel), one host fetch a chunk; slots in other phases ride
    along inert;
  * modality: parked slots group by (modality, shape); each group
    integrates one batched ODE over the pool (`_ode_impl`, the decode kernel
    at nq = L) and writes the segment into its members' caches;
  * retirement: a slot frees the moment its request hits eos or its budget.

Where the port differs from the JAX engine, and why:

  * In-place cache writes. The grouped ODE and the append write every pool
    row's segment after its index (a non-member's write masked invalid);
    JAX's functional update clamps such a write, the port's `scatter_`
    would fault. So (1) a slot's index and mask return to 0 when it frees,
    and (2) the pool rebuilds when ANY occupied slot's segment write would
    overflow, not only a member's (as `sample_batch` checks every row). A
    rebuild keeps every request's output, so neither changes a result; (2)
    can rebuild where JAX does not only in a pool too small for its
    workload (`for_workload` sizes it so no rebuild fires).
  * The admission rectangle is at most `cap` wide (JAX's prefill fails when
    a prompt's width bucket exceeds the pool's capacity).
  * Randomness. The engine takes `seed: int` where JAX takes `rng`. Text
    draws come from the streams of `sample_batch` keyed by (seed, request
    id, tokens sampled), modality noise by (seed, request id, segments), as
    JAX folds them: a request's output does not depend on its slot or its
    co-tenants, and the engine reproduces `sample_batch` where request ids
    equal batch indices.
  * KV policy. `kv_quantize=None` takes the port's `plan_serving` (bf16 /
    float32 unless int8 is requested); JAX applies its TPU crossovers.
  * `warmup()` has nothing to compile in eager PyTorch: it skips JAX's
    pick and admission traces and times the chunk ladder (every power of
    two k <= `text_chunk`, twice each) and one grouped ODE + append per
    shape.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from transfusion_tpu_torch.data.packing import to_user_layout
from transfusion_tpu_torch.models import sample_batch as _sb
from transfusion_tpu_torch.models import serving
from transfusion_tpu_torch.models.engine import _fit_cost_model
from transfusion_tpu_torch.models.sample_batch import (
    _NOISE_STREAM,
    _consume,
    _draw_seed,
    _Req,
    _round_up,
    _seq_stats,
    _transition,
    _uncond_of,
)
from transfusion_tpu_torch.models.serving import choose_chunk

logger = logging.getLogger(__name__)

_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def _bucket_len(n: int, mult: int) -> int:
    """Power-of-two multiple of pad_multiple >= n (sample_batch's width
    buckets)."""
    chunks = max(1, -(-int(n) // mult))
    return mult * (1 << (chunks - 1).bit_length())


def _admit_impl(model, pool, pool_logits, packed, slots_c, slots_all, *, cap, quantize):
    """Prefill a group of admitted prompts (cond rows, then their uncond
    twins) and copy the rows into the pool at their slots, in place."""
    last, side = model._prefill_impl(packed, cap=cap, quantize=quantize)
    for kk in _KV_KEYS:
        if kk in pool:
            pool[kk].index_copy_(1, slots_all, side[kk])
    pool["mask"].index_copy_(0, slots_all, side["mask"])
    lengths = torch.as_tensor(np.asarray(packed.lengths), dtype=torch.int32,
                              device=pool["idx"].device)
    pool["idx"].index_copy_(0, slots_all, lengths)
    pool_logits.index_copy_(0, slots_c, last[: slots_c.shape[0]].float())
    return pool, pool_logits


class _MMSlot:
    __slots__ = ("rid", "req", "max_length")

    def __init__(self, rid, req, max_length):
        self.rid = rid
        self.req = req
        self.max_length = max_length


class FinishedRequest:
    __slots__ = ("rid", "items", "output")

    def __init__(self, rid, items, output):
        self.rid = rid
        self.items = items  # sample items: text arrays and (type, latent)
        self.output = output  # the items with each modality decoded


class MultimodalServingEngine:
    def __init__(self, model, *, max_requests: int, max_seq_len: int, cfg_scale: float = 3.0,
                 modality_steps: int = 16, text_temperature: float = 1.5,
                 text_min_p: float = 0.1, fixed_modality_shape: Optional[tuple] = None,
                 init_modality_noise=None, text_chunk: int = 64,
                 kv_quantize: Optional[bool] = None,
                 return_unprocessed_modalities: bool = False, seed: int = 0, metrics=None):
        """model: a port `Transfusion` with a text vocabulary. text_chunk:
        the most text steps a chunk runs; the cost model and the observed
        text-segment lengths size each chunk. init_modality_noise pins every
        segment's noise (parity testing). metrics: an optional
        `training.metrics.MetricsLogger`, one row a tick."""
        assert model.num_text_tokens > 0, (
            "the multimodal engine drives sample()'s AR text machinery — use "
            "generate_modality_only (already batched) for pure-modality models"
        )
        self.model = model
        self.device = model.device
        self.R = int(max_requests)
        self.cfg_scale = float(cfg_scale)
        self.use_cfg = self.cfg_scale != 1.0
        self.rows = 2 * self.R if self.use_cfg else self.R
        self.modality_steps = int(modality_steps)
        self.text_temperature = float(text_temperature)
        self.text_min_p = float(text_min_p)
        self.fixed_modality_shape = fixed_modality_shape
        self.init_modality_noise = init_modality_noise
        self.text_chunk = int(text_chunk)
        self._kv_quantize_arg = kv_quantize
        self.return_unprocessed = bool(return_unprocessed_modalities)
        self.seed = int(seed)

        self.cap = _round_up(max(int(max_seq_len), 128), 128)
        self._quantize = model._plan(self.cap, self.rows, kv_quantize).kv_quantize
        self.cache = model._cache(self.rows, self.cap, self._quantize, track_mask=True)
        self.cache["idx"] = torch.zeros((self.rows,), dtype=torch.int32, device=self.device)
        self.last_logits = torch.zeros((self.R, model.vocab_size), device=self.device)
        # in-chunk stop set: modality triggers and eos
        self._stop_ids = torch.as_tensor([*model.som_ids, model.eos_id], dtype=torch.int64,
                                         device=self.device)

        self.queue: deque = deque()
        self.slots: list = [None] * self.R
        self._next_rid = 0
        self.stats = {"admitted": 0, "finished": 0, "text_tokens": 0, "modality_tokens": 0,
                      "text_chunks": 0, "ode_dispatches": 0, "rebuilds": 0}
        # the dispatch-cost model (as ServingEngine's), and the grouped ODE's
        # seconds per (modality, shape): one dispatch serves every member
        self._chunk_samples: dict = {}
        self._rtt_est = serving.DEFAULT_RTT_S
        self._step_est = serving.DEFAULT_STEP_S
        self.cost_fit = "priors"
        self._ode_samples: dict = {}
        self._cost_frozen = False
        # EWMA of text-segment lengths (segment start to som / eos / budget):
        # caps the chunk chooser's useful tokens a row; None until one ends
        self._seg_ewma = None
        self._seg_start: dict = {}  # rid -> tokens sampled at its segment start
        self.metrics = metrics
        self._tick = 0

    @classmethod
    def for_workload(cls, model, prompts, max_length, *, max_requests, **kw):
        """An engine sized so that no prompt of `prompts` (each budgeted
        `max_length` tokens) can overflow the pool: `sample_batch`'s
        capacity formula over the workload."""
        need = 0
        for p in prompts:
            tc, _ = _seq_stats(model, model._prompt_to_items(p))
            need = max(need, tc + int(max_length) + 256 + 2)
        return cls(model, max_requests=max_requests, max_seq_len=need, **kw)

    # ------------------------------------------------------------------

    def submit(self, prompt, max_length: int = 2048) -> int:
        items = self.model._prompt_to_items(prompt)
        tc, co = _seq_stats(self.model, items)
        assert tc + 2 <= self.cap, (
            f"prompt ({tc} tokens) cannot fit the pool capacity {self.cap} — raise max_seq_len"
        )
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_MMSlot(rid, _Req(items, tc, co), int(max_length)))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def _rows_of(self, slots):
        """The pool rows of `slots`: the cond rows, then the uncond twins."""
        slots = list(slots)
        return slots + [self.R + s for s in slots] if self.use_cfg else slots

    # ------------------------------------------------------------------

    @staticmethod
    def _pow2_splits(n: int):
        """n split into power-of-two group sizes, largest first (as JAX
        bounds its admission traces)."""
        out = []
        while n > 0:
            p = 1 << (n.bit_length() - 1)
            out.append(p)
            n -= p
        return out

    def _admit_pending(self):
        model = self.model
        groups = {}
        for slot in range(self.R):
            if not self.queue:
                break
            if self.slots[slot] is not None:
                continue
            ent = self.queue.popleft()
            width = min(_bucket_len(max(ent.req.tok_count, 1), model.pad_multiple), self.cap)
            groups.setdefault(width, []).append((slot, ent))
        subgroups = []
        for width, pairs in groups.items():
            i = 0
            for sz in self._pow2_splits(len(pairs)):
                subgroups.append((width, pairs[i : i + sz]))
                i += sz
        for width, pairs in subgroups:
            batch_items = [ent.req.items for _, ent in pairs]
            if self.use_cfg:
                batch_items += [_uncond_of(model, ent.req.items) for _, ent in pairs]
            packed = model.pack(batch_items, wrap_sos_eos=False, add_meta=False,
                                pad_multiple=width)
            slots_c = [s for s, _ in pairs]
            self.cache, self.last_logits = _admit_impl(
                model, self.cache, self.last_logits, packed,
                torch.as_tensor(slots_c, device=self.device),
                torch.as_tensor(self._rows_of(slots_c), device=self.device),
                cap=self.cap, quantize=self._quantize)
            for (slot, ent), ln in zip(pairs, np.asarray(packed.lengths)):
                ent.req.slots_used = int(ln)
                ent.req.pending = None
                _transition(model, ent.req, self.fixed_modality_shape)
                self.slots[slot] = ent
                self._seg_start[ent.rid] = 0
                self.stats["admitted"] += 1

    def _rebuild(self, new_cap: int):
        """Re-prefill every occupied slot into a fresh pool of a larger
        capacity (free slots hold one sos token). Correct but expensive:
        size max_seq_len (`for_workload`) so that it never fires."""
        model = self.model
        self.cap = _round_up(new_cap, 128)
        self._quantize = model._plan(self.cap, self.rows, self._kv_quantize_arg).kv_quantize
        batch_items = [ent.req.items if ent else [np.asarray([model.sos_id], np.int32)]
                       for ent in self.slots]
        if self.use_cfg:
            batch_items += [_uncond_of(model, items) for items in batch_items[: self.R]]
        packed = _sb._width_bucket_pack(model, batch_items, self.cap)
        last, cache = model._prefill_impl(packed, cap=self.cap, quantize=self._quantize)
        lengths = np.asarray(packed.lengths, np.int64)
        self.cache = {**cache, "idx": torch.as_tensor(lengths, dtype=torch.int32,
                                                      device=self.device)}
        self.last_logits = last[: self.R].float()
        for slot, ent in enumerate(self.slots):
            if ent is None:
                continue
            r = ent.req
            r.tok_count, r.collapse = _seq_stats(model, r.items)
            r.slots_used = int(lengths[slot])
            # live text rows pick again from the fresh logits with the same
            # (rid, tokens sampled) draw the streamed path would have used
            r.pending = None
        self.stats["rebuilds"] += 1

    def _retire_overlong(self):
        for ent in self.slots:
            if ent and not ent.req.done and ent.req.curr_length > ent.max_length:
                ent.req.done = True

    # ------------------------------------------------------------------
    # the dispatch-cost model
    # ------------------------------------------------------------------

    def _note_segment(self, rid: int, n_sampled: int):
        """A request's text segment just ended (som park, eos or budget):
        fold its length into the EWMA that caps the chunk chooser."""
        seg = n_sampled - self._seg_start.get(rid, 0)
        self._seg_start[rid] = n_sampled
        if seg <= 0:
            return
        if self._seg_ewma is None:
            self._seg_ewma = float(seg)
        else:
            self._seg_ewma = 0.8 * self._seg_ewma + 0.2 * float(seg)

    def _seg_cap(self) -> Optional[int]:
        """Expected useful tokens a streaming row yields before its som
        (1.5x the EWMA plus headroom); None until a segment was seen."""
        if self._seg_ewma is None:
            return None
        return max(4, int(self._seg_ewma * 1.5) + 2)

    def _chunk_len(self, stream) -> int:
        """The text-chunk length that maximizes useful tokens per second
        under the cost model, each row's useful tokens capped at its budget
        and at the segment-length EWMA (rows stop at som inside the chunk)."""
        if not self._cost_frozen:
            _fit_cost_model(self)
        cap = self._seg_cap()
        rem = []
        for i in stream:
            ent = self.slots[i]
            r = ent.req
            if r.parked or r.done:
                rem.append(1)  # flush-only row
                continue
            b = ent.max_length - r.curr_length + 1
            rem.append(min(b, cap) if cap is not None else b)
        return choose_chunk(rem, self._rtt_est, self._step_est, self.text_chunk)

    def ode_cost(self, mid=0, shape=None) -> Optional[float]:
        """Measured seconds of one grouped ODE dispatch (integrate, append,
        fetch) at (mid, shape); else the mean over every measured group;
        None when nothing was measured (run warmup)."""
        if shape is not None:
            ts = self._ode_samples.get((mid, tuple(shape)))
            if ts:
                return float(np.mean(ts))
        all_ts = [t for ts in self._ode_samples.values() for t in ts]
        return float(np.mean(all_ts)) if all_ts else None

    # ------------------------------------------------------------------
    # device calls of a tick
    # ------------------------------------------------------------------

    def _text_gumbel(self, keys, k=None):
        """The draws of one pick (k None: Float[R, vocab]) or of a k-step
        chunk (Float[k, R, vocab]); keys: (rid, count) a slot, None for slots
        whose draw is discarded. None at temperature 0."""
        if self.text_temperature == 0.0:
            return None
        if k is None:
            return _sb._gumbel_rows(self.seed, keys, self.model.vocab_size, self.device)
        rows = [None if key is None else (key[0], key[1] + j) for j in range(k) for key in keys]
        return _sb._gumbel_rows(self.seed, rows, self.model.vocab_size,
                                self.device).view(k, self.R, -1)

    def _chunk(self, toks0, pos0, act0, rem, keys, k):
        """One text chunk and its one fetch: payload [R, 2k] numpy."""
        dev = self.device
        payload, self.cache = _sb._chunk_tick_impl(
            self.model, self.cache, torch.as_tensor(toks0, device=dev),
            torch.as_tensor(pos0, device=dev), torch.as_tensor(act0, device=dev),
            torch.as_tensor(rem, device=dev), self._text_gumbel(keys, k),
            temperature=self.text_temperature, min_p=self.text_min_p, R=self.R, k=k,
            stop_ids=self._stop_ids)
        return _sb._fetch(payload)

    def _ode_group(self, mid, spatial, L, noise, p0, member):
        """One grouped ODE over the pool, the append into the members'
        caches, and the one fetch of the sampled latents."""
        p0_t = torch.as_tensor(p0, device=self.device)
        member_t = torch.as_tensor(member, device=self.device)
        sampled = _sb._ode_impl(self.model, self.cache, noise, p0_t, member_t,
                                self.cfg_scale, mid=mid, L=L, steps=self.modality_steps,
                                use_cfg=self.use_cfg, R=self.R)
        self.cache = _sb._append_impl(self.model, self.cache, sampled, p0_t, member_t,
                                      mid=mid, L=L, R=self.R)
        return _sb._fetch(sampled)

    def warmup(self, shapes=None):
        """Time the text-chunk ladder (every power of two k <= text_chunk,
        twice, the first run excluded) and one grouped ODE + append per
        (modality, shape) in `shapes` (default: every modality's default
        shape), all on inert rows, so the pool is left as it was; fit the
        cost model and freeze it. A shape whose segment does not fit after
        the pool's highest index is not timed (logged)."""
        R, rows = self.R, self.rows
        toks0, pos0 = np.zeros(R, np.int64), np.zeros(rows, np.int64)
        inert, rem = np.zeros(R, bool), np.ones(R, np.int64)
        keys = [None] * R
        k = 1
        while k <= self.text_chunk:
            for first in (True, False):
                t0 = time.perf_counter()
                self._chunk(toks0, pos0, inert, rem, keys, k)
                if not first:
                    self._chunk_samples.setdefault(k, []).extend([0.0, time.perf_counter() - t0])
            k <<= 1
        _fit_cost_model(self)

        if shapes is None:
            shapes = [(mid, tuple(mc.default_shape)) for mid, mc in enumerate(self.model.modalities)
                      if mc.default_shape is not None]
        top = max([1] + [ent.req.slots_used for ent in self.slots if ent is not None])
        for mid, shape in shapes:
            spatial = tuple(shape)
            L = self.model.seq_len_for(mid, spatial)
            if top + L > self.cap:
                logger.info("warmup: ODE of shape %s not timed (%d + %d > cap %d)",
                            spatial, top, L, self.cap)
                continue
            noise = torch.zeros((R, *spatial, self.model.modalities[mid].dim_latent),
                                device=self.device)
            for first in (True, False):
                t0 = time.perf_counter()
                self._ode_group(mid, spatial, L, noise, np.zeros(rows, np.int64),
                                np.zeros(rows, bool))
                if not first:
                    self._ode_samples.setdefault((mid, spatial), []).append(
                        time.perf_counter() - t0)
        self._cost_frozen = True

    def serve(self, prompts, max_length, *, expected_segments=1.0, plan_only: bool = False):
        """Serve a batch by continuous batching or by fixed `sample_batch`
        waves, whichever `serving.plan_dispatch_mm` estimates faster under
        the fitted cost model (unmeasured ODE: `serving.DEFAULT_ODE_S`); one
        result per prompt, in order. max_length and expected_segments: one
        value, or one per prompt. Both paths take the longest budgets first.
        plan_only: return the decision ('engine' | 'waves') alone."""
        n = len(prompts)
        if isinstance(max_length, (int, float)):
            max_lengths = [int(max_length)] * n
        else:
            max_lengths = [int(v) for v in max_length]
            assert len(max_lengths) == n, (len(max_lengths), n)
        if isinstance(expected_segments, (int, float)):
            exp_segs = [float(expected_segments)] * n
        else:
            exp_segs = [float(v) for v in expected_segments]
            assert len(exp_segs) == n, (len(exp_segs), n)
        # text budget ~ total budget less the expected modality tokens
        L_est = 0
        if self.model.modalities:
            shp = (tuple(self.fixed_modality_shape) if self.fixed_modality_shape is not None
                   else tuple(self.model.modalities[0].default_shape or ()))
            if shp:
                L_est = self.model.seq_len_for(0, shp)
        ode_s = self.ode_cost()
        reqs = [(max(8, ml - int(es * L_est)), es) for ml, es in zip(max_lengths, exp_segs)]
        plan = serving.plan_dispatch_mm(
            reqs, self.R, self._rtt_est, self._step_est,
            ode_s if ode_s is not None else serving.DEFAULT_ODE_S,
            max_chunk=self.text_chunk, seg_cap=self._seg_cap(), seg_tokens=L_est)
        if plan_only:
            return plan
        order = sorted(range(n), key=lambda i: (-max_lengths[i], i))
        if plan == "waves":
            out = [None] * n
            for i in range(0, n, self.R):
                idxs = order[i : i + self.R]
                outs = _sb.sample_batch(
                    self.model, [prompts[j] for j in idxs], seed=self.seed,
                    max_length=[max_lengths[j] for j in idxs],
                    text_temperature=self.text_temperature, text_min_p=self.text_min_p,
                    fixed_modality_shape=self.fixed_modality_shape,
                    init_modality_noise=self.init_modality_noise,
                    modality_steps=self.modality_steps, cfg_scale=self.cfg_scale,
                    kv_quantize=self._kv_quantize_arg,
                    return_unprocessed_modalities=self.return_unprocessed,
                    text_chunk=self.text_chunk)
                for j, o in zip(idxs, outs):
                    out[j] = o
            return out
        rids = [None] * n
        for i in order:
            rids[i] = self.submit(prompts[i], max_lengths[i])
        by_rid = {f.rid: f.output for f in self.run()}
        return [by_rid[rid] for rid in rids]

    def step(self):
        """One tick: admit, pick for the slots that need it, advance the
        text slots one chunk, integrate one round of modality groups,
        retire. Returns the FinishedRequests."""
        model, R, rows = self.model, self.R, self.rows
        admitted_before = self.stats["admitted"]
        tick_chunk_k, tick_chunk_s, tick_ode = 0, 0.0, 0
        self._admit_pending()
        n_admitted = self.stats["admitted"] - admitted_before
        live = [i for i in range(R) if self.slots[i] is not None and not self.slots[i].req.done]
        if not live:
            return self._collect_finished()
        self._retire_overlong()

        # pick: text-phase slots with nothing pending (after admission or a
        # rebuild) sample from the stored logits
        need_pick = [i for i in live if not self.slots[i].req.done
                     and not self.slots[i].req.parked and self.slots[i].req.pending is None]
        if need_pick:
            keys = [None] * R
            for i in need_pick:
                keys[i] = (self.slots[i].rid, self.slots[i].req.n_sampled)
            picks = _sb._fetch(_sb._pick_impl(
                model, self.last_logits, self._text_gumbel(keys),
                temperature=self.text_temperature, min_p=self.text_min_p))
            for i in need_pick:
                ent = self.slots[i]
                _consume(model, ent.req, int(picks[i]), self.fixed_modality_shape)
                self.stats["text_tokens"] += 1
                if ent.req.done or ent.req.parked:
                    self._note_segment(ent.rid, ent.req.n_sampled)
            self._retire_overlong()

        # chunked text decode (stops inside the chunk at som / eos / budget)
        stream = [i for i in live if self.slots[i].req.pending is not None]
        if stream:
            toks0 = np.zeros(R, np.int64)
            pos0 = np.zeros(rows, np.int64)
            act0 = np.zeros(R, bool)
            rem = np.zeros(R, np.int64)
            keys = [None] * R
            for i in stream:
                ent = self.slots[i]
                r = ent.req
                toks0[i] = r.pending
                pos0[i] = r.tok_count - r.collapse
                act0[i] = True
                rem[i] = 1 if (r.parked or r.done) else ent.max_length - r.curr_length + 1
                keys[i] = (ent.rid, r.n_sampled)
                if self.use_cfg:
                    pos0[R + i] = pos0[i]
            k = self._chunk_len(stream)
            t0 = time.perf_counter()
            payload = self._chunk(toks0, pos0, act0, rem, keys, k)
            elapsed = time.perf_counter() - t0
            if not self._cost_frozen:
                self._chunk_samples.setdefault(k, []).append(elapsed)
            tick_chunk_k, tick_chunk_s = k, elapsed
            toks_e, emits = payload[:, :k], payload[:, k:].astype(bool)
            self.stats["text_chunks"] += 1
            for i in stream:
                ent = self.slots[i]
                r = ent.req
                m = int(emits[i].sum())
                r.tok_count += m
                r.slots_used += m
                if r.parked or r.done:
                    r.pending = None  # som flushed / eos never continued
                else:
                    for j in range(m):
                        _consume(model, r, int(toks_e[i, j]), self.fixed_modality_shape)
                        self.stats["text_tokens"] += 1
                        if r.done or r.parked:
                            self._note_segment(ent.rid, r.n_sampled)
                            break
            self._retire_overlong()

        # ODE: parked slots grouped by (modality, shape)
        groups = {}
        for i in live:
            r = self.slots[i].req
            if not r.done and r.parked and r.pending is None:
                groups.setdefault((r.mid, r.shape), []).append(i)
        for (mid, spatial), members in groups.items():
            mc = model.modalities[mid]
            L = model.seq_len_for(mid, spatial)
            occupied = [ent for ent in self.slots if ent is not None]
            # every row writes the segment after its index (see the module
            # docstring), so every occupied slot must hold it
            if any(ent.req.slots_used + L + 2 > self.cap for ent in occupied):
                self._rebuild(max(ent.req.slots_used for ent in occupied) + L + 256)
            noise = torch.zeros((R, *spatial, mc.dim_latent), device=self.device)
            member = np.zeros(rows, bool)
            p0 = np.zeros(rows, np.int64)
            for i, ent in enumerate(self.slots):
                if ent is not None:
                    p0[i] = ent.req.tok_count - ent.req.collapse
                if self.use_cfg:
                    p0[R + i] = p0[i]
            for i in members:
                ent = self.slots[i]
                member[self._rows_of([i])] = True
                g = None
                if self.init_modality_noise is None:
                    g = torch.Generator(device=self.device).manual_seed(
                        _draw_seed(self.seed, _NOISE_STREAM, ent.rid, ent.req.n_segments))
                noise[i] = model._segment_noise(self.init_modality_noise, spatial, mid, g)
            t0 = time.perf_counter()
            sampled = self._ode_group(mid, spatial, L, noise, p0, member)
            if not self._cost_frozen:
                self._ode_samples.setdefault((mid, spatial), []).append(time.perf_counter() - t0)
            tick_ode += 1
            self.stats["ode_dispatches"] += 1
            for i in members:
                r = self.slots[i].req
                r.items.append((mid, to_user_layout(sampled[i], mc.channel_first_latent)))
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
                self.stats["modality_tokens"] += L
            self._retire_overlong()

        finished = self._collect_finished()
        if self.metrics is not None:
            self._tick += 1
            predicted = self._rtt_est + tick_chunk_k * self._step_est if tick_chunk_k else 0.0
            self.metrics.log(self._tick, {
                "admitted": n_admitted,
                "retired": len(finished),
                "chunk_k": tick_chunk_k,
                "chunk_seconds": tick_chunk_s,
                "cost_model_residual_s": tick_chunk_s - predicted,
                "ode_groups": tick_ode,
                "seg_ewma": self._seg_ewma or 0.0,
                "active_slots": sum(1 for s in self.slots if s is not None and not s.req.done),
                "queue_depth": len(self.queue),
            })
        return finished

    def _collect_finished(self):
        """Retire the finished slots; a freed slot's rows get index 0 and an
        empty mask (see the module docstring)."""
        finished, freed = [], []
        for slot, ent in enumerate(self.slots):
            if ent is None or not ent.req.done:
                continue
            items = ent.req.items
            output = items if self.return_unprocessed else self.model.decode_modalities(items)
            finished.append(FinishedRequest(ent.rid, items, output))
            self.slots[slot] = None
            freed.append(slot)
            self.stats["finished"] += 1
        if freed:
            rows = torch.as_tensor(self._rows_of(freed), device=self.device)
            self.cache["idx"].index_fill_(0, rows, 0)
            self.cache["mask"].index_fill_(0, rows, False)
        return finished

    def run(self, prompts=None, max_length: Optional[int] = None):
        """Drive until the queue and every slot drain, after submitting
        `prompts` (each budgeted `max_length`) when given. Returns the
        FinishedRequests in completion order."""
        if prompts is not None:
            assert max_length is not None
            for p in prompts:
                self.submit(p, max_length)
        out = []
        while self.has_work:
            out.extend(self.step())
        return out
