"""Continuous-batching text-serving engine (counterpart of
`transfusion_tpu/models/engine.py`).

A fixed pool of `max_batch` cache rows; requests are admitted into free
rows as they arrive and retire the moment they finish, so a short request
never waits for the longest row of a static batch (`generate_text_batch`).

  * One KV cache of `max_batch` rows with per-row write offsets
    (`idx: Int[b]`) and a validity mask, so every row lives at its own
    history length.
  * Admission: queued requests pair with free rows, grouped by prompt-width
    bucket; each group prefills as one rectangle through
    `TransfusionCore.text_forward(prefill=True)` (the flash kernel) into a
    side cache, whose K/V, scales, mask, idx and last logits are then copied
    into the pool at the group's rows (`index_copy_` on the row dimension).
  * Decode: every row advances together in chunks of k steps (`_decode_step`,
    the decode kernel, on the static buffers of a `DecodeGraph` over the
    pool): a row stops inside
    the chunk on its budget or on EOS; inert rows keep their index pinned and
    their fresh slot masked invalid. The chunk comes back as one
    [B, 2k + 1] payload (tokens, emit mask, final active flag): one host
    fetch a chunk, and nothing inside the chunk reads the device. On a CUDA
    device the first chunk on a pool captures the step into a CUDA graph
    and every chunk replays it once a step, so the card paces decoding, not
    the host launching each of the step's kernels from Python; elsewhere
    the same step runs eagerly.
  * Chunk lengths come from a dispatch-cost model (`choose_chunk`) that
    `warmup()` fits on the running device: on the card the fitted `rtt` is
    the fixed host cost of a chunk (launch, fetch, bookkeeping), `step` one
    decode step.
  * Observability: `metrics=` takes one row a tick (`step`), and under a
    profiler a tick shows as the span `transfusion.engine.tick` holding
    `.admit` (one `.prefill` a width group, its args the width and rows),
    `.plan` (the chunk length), `.decode` (the chunk's draws and launches, or
    graph replays), `.fetch` (the host blocked on the chunk's payload) and
    `.retire` (`training.metrics.span`). A tick row's `graph_steps` counts
    the chunk's steps replayed from a graph.

Where the port differs from the JAX engine, and why:

  * In-place cache writes. JAX's functional update clamps an out-of-range
    write; the port's `scatter_` would fault. A row that fills its capacity
    exactly (`prompt + max_new_tokens == cap`, allowed) ends its last
    active step with its index at `cap`, and the inert steps after it would
    write slot `cap`. So a row's index returns to 0 on the step it stops:
    the rest of its chunk writes slot 0 of a retired row, masked invalid,
    and its next admission overwrites the whole row. No output changes.
  * The admission rectangle is at most `cap` wide. A prompt whose width
    bucket exceeds the capacity (a 600-token prompt in a 640-slot pool)
    fails in the JAX engine (its prefill cannot write past the side cache);
    here the bucket is clamped to the capacity, and the padding is masked.
  * Randomness. The engine takes `seed: int` where JAX takes `rng`. At
    temperature > 0 the draws of a chunk's k steps are made before its loop,
    each from a `torch.Generator` seeded from (seed, the engine's stream,
    request id, token count) (`sample_batch._draw_seed`): a request's tokens
    do not depend on its row, its co-tenants or the chunk sizes, as in JAX,
    though the streams are the port's own.
  * `warmup()` has nothing to compile in eager PyTorch; it times the chunk
    ladder (every power of two k <= `decode_chunk`, twice each: 2 x (2 *
    decode_chunk - 1) inert decode steps, 1022 at the default 256) and the
    cap slope (2 x 64 more steps on a half-capacity scratch pool, which
    captures a graph of its own, dropped after), on the path the chunks
    take: on a CUDA device the replayed graph, captured by the first chunk
    if none has run yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from transfusion_tpu_torch.models import sample_batch as _sb
from transfusion_tpu_torch.models import serving
from transfusion_tpu_torch.models.serving import choose_chunk
from transfusion_tpu_torch.models.transformer import cache_mark_valid
from transfusion_tpu_torch.ops.decode_attn import decode_attention
from transfusion_tpu_torch.training.metrics import span

logger = logging.getLogger(__name__)

__all__ = ["Request", "ServingEngine", "choose_chunk"]

# the engine's stream of draws (sample_batch takes 0 and 1)
_ENGINE_STREAM = 2

_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def _width_bucket(n: int) -> int:
    """Next power-of-two multiple of 128 (the prefill widths of
    `generate_text_batch`)."""
    chunks = -(-max(n, 1) // 128)
    return 128 * (1 << (chunks - 1).bit_length())


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # 1-D int32
    max_new_tokens: int
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    submitted: float = 0.0  # host time (`time.perf_counter`) of its submit


def _fit_cost_model(engine):
    """Least-squares (rtt, step) over `engine`'s clean chunk timings
    {k: [seconds]} (the first of each k excluded), once there are 3 points
    at 2 lengths. A fit is kept only when both terms come out positive;
    otherwise the estimates in force stay (on a host-bound card a chunk's
    fixed cost can fit to ~0). `engine.cost_fit` records which happened."""
    pts = [(k, t) for k, ts in engine._chunk_samples.items() for t in ts[1:]]
    if len({k for k, _ in pts}) < 2 or len(pts) < 3:
        return
    step, rtt = (float(x) for x in np.polyfit(np.array([p[0] for p in pts], np.float64),
                                              np.array([p[1] for p in pts], np.float64), 1))
    if step > 0 and rtt > 0:
        engine._step_est, engine._rtt_est = step, rtt
        engine.cost_fit = "fitted"
    else:
        engine.cost_fit = f"fit rejected (rtt {rtt:.6f} s, step {step:.6f} s): estimates kept"
    logger.info("cost model: %s; rtt %.6f s, step %.6f s", engine.cost_fit,
                engine._rtt_est, engine._step_est)


def _text_ids(model, device):
    """Bool[1, vocab]: the ids a decode step may sample (text tokens)."""
    return torch.arange(model.vocab_size, device=device)[None] < model.num_text_tokens


def _decode_step(model, cache, last, active, left, gumbel, text_only, *, temperature, min_p,
                 eos_id):
    """One decode step over the pool: every row samples from its last
    logits (text ids only; gumbel Float[B, vocab], or None at temperature
    0) and streams that token; an active row emits it, spends one of its
    budget and stops on the budget or on EOS, and on the step it stops its
    index returns to 0 (see the module docstring). Inactive rows write
    their slot at the pinned index, masked invalid. Returns (cache, last
    logits, active after the step, left, the step's tokens)."""
    masked = torch.where(text_only, last, float("-inf"))
    tok = _sb._pick_impl(model, masked, gumbel, temperature=temperature, min_p=min_p)
    old_idx = cache["idx"]
    cache = cache_mark_valid(cache, active[:, None])
    logits, cache = model.core.text_forward(tok[:, None], cache, old_idx[:, None].long())
    last = torch.where(active[:, None], logits[:, -1].float(), last)
    left = left - active.to(left.dtype)
    stop = left <= 0
    if eos_id is not None:
        stop = stop | (tok == eos_id)
    nxt = active & ~stop
    idx = torch.where(nxt, cache["idx"], torch.where(active, 0, old_idx))
    return {**cache, "idx": idx}, last, nxt, left, tok


class DecodeGraph:
    """One decode step (`_decode_step`) over a pool, on static buffers: the
    pool's own cache tensors and last logits, which it updates in place,
    and buffers of its own for the rows' active flags, budgets, the step's
    gumbel row (at temperature > 0), token and emit flag. What the
    functional step rebinds (the mask `cache_mark_valid` clones, idx, last,
    active, left) is copied back into its buffer, so the next step reads
    it, and `_admit_group`'s `index_copy_` into the pool reaches the step.

    `capture()` records the step into a `torch.cuda.CUDAGraph`; `chunk()`
    then replays it once a step, so a step costs the host one graph launch
    and two small copies, where the eager step launches every kernel of the
    model from Python. Uncaptured (off a CUDA device), `chunk()` runs the
    same step eagerly."""

    def __init__(self, model, cache, last, *, temperature, min_p, eos_id):
        b, dev = last.shape[0], last.device
        self.model, self.cache, self.last = model, cache, last
        self.active = torch.zeros(b, dtype=torch.bool, device=dev)
        self.left = torch.zeros(b, dtype=torch.int32, device=dev)
        self.gumbel = torch.zeros_like(last) if temperature > 0.0 else None
        self.tok = torch.zeros(b, dtype=torch.int64, device=dev)
        self.emit = torch.zeros(b, dtype=torch.bool, device=dev)
        self.text_only = _text_ids(model, dev)
        self.opts = dict(temperature=temperature, min_p=min_p, eos_id=eos_id)
        self.graph = None
        self.decode_launches = 0  # decode kernel launches the capture recorded
        self.replays = 0

    def step(self):
        """One step from the static buffers back into them."""
        self.emit.copy_(self.active)
        cache, last, active, left, tok = _decode_step(
            self.model, self.cache, self.last, self.active, self.left, self.gumbel,
            self.text_only, **self.opts)
        if "mask" in self.cache:
            self.cache["mask"].copy_(cache["mask"])
        self.cache["idx"].copy_(cache["idx"])
        self.last.copy_(last)
        self.active.copy_(active)
        self.left.copy_(left)
        self.tok.copy_(tok)

    def capture(self):
        """Record `step` into a CUDA graph. Two inert steps (no row active)
        run first on a side stream, as capture asks; an inert step changes
        nothing a later step reads (its writes land at pinned indices,
        masked invalid), so the pool may hold live rows."""
        dev = self.last.device
        self.active.zero_()
        self.left.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = decode_attention.launches
        with torch.cuda.graph(graph):
            self.step()
        self.decode_launches = decode_attention.launches - before
        self.graph = graph

    def chunk(self, active, left, gumbel, *, k):
        """k steps with per-row stopping, all on the device, from the rows'
        active flags Bool[B] and remaining budgets Int[B] (gumbel Float[k, B,
        vocab], or None at temperature 0), replayed from the graph once
        captured. Returns the payload Int64[B, 2k + 1] on the device: tokens,
        emit mask, final active flag."""
        self.active.copy_(active)
        self.left.copy_(left)
        payload = torch.empty((self.tok.shape[0], 2 * k + 1), dtype=torch.int64,
                              device=self.tok.device)
        for j in range(k):
            if gumbel is not None:
                self.gumbel.copy_(gumbel[j])
            if self.graph is None:
                self.step()
            else:
                self.graph.replay()
                self.replays += 1
            payload[:, j].copy_(self.tok)
            payload[:, k + j].copy_(self.emit)
        payload[:, 2 * k].copy_(self.active)
        return payload


class ServingEngine:
    def __init__(self, model, *, max_batch: int, max_seq_len: int, decode_chunk: int = 256,
                 temperature: float = 0.0, min_p: float = 0.0,
                 kv_quantize: Optional[bool] = None, eos_id: Optional[int] = None,
                 seed: int = 0, metrics=None):
        """model: a port `Transfusion` (its device and weights serve).
        decode_chunk: the most decode steps a chunk runs; chunks are sized
        by the cost model. kv_quantize: int8 cache (`plan_serving`).
        metrics: an optional `training.metrics.MetricsLogger`, one row a
        tick: admitted, retired, chunk_k, chunk_seconds (the chunk's host
        time, ending in its one fetch), cost_model_residual_s,
        emitted_tokens, active_slots, queue_depth; and admit_seconds (host
        time in admission and prefill), prompt_tokens (the admitted
        prompts' tokens), prefill_positions (each prefill group's width
        times its rows), queued_seconds (the admitted requests' waits from
        submit to admission, summed), dispatch_seconds and fetch_seconds
        (chunk_seconds before the fetch, and blocked in it)."""
        self.model = model
        self.device = model.device
        self.max_batch = int(max_batch)
        self.decode_chunk = int(decode_chunk)
        self.temperature = float(temperature)
        self.min_p = float(min_p)
        self.eos_id = eos_id
        self.seed = int(seed)

        self.cap = -(-int(max_seq_len) // 128) * 128
        self._quantize = model._plan(self.cap, self.max_batch, kv_quantize).kv_quantize
        self.cache = self._pool(self.cap)
        self.last_logits = torch.zeros((self.max_batch, model.vocab_size), device=self.device)

        self.queue: deque = deque()
        self.slots: list = [None] * self.max_batch
        self.active = np.zeros(self.max_batch, bool)
        self._next_rid = 0
        self.stats = {"generated_tokens": 0, "decode_chunks": 0, "admitted": 0,
                      "decode_time_s": 0.0, "graph_steps": 0}
        # the dispatch-cost model: per chunk length, (k, seconds) samples;
        # the first of each length is excluded (the length's first run)
        self._chunk_samples: dict = {}
        self._rtt_est = serving.DEFAULT_RTT_S  # the card's priors until a fit
        self._step_est = serving.DEFAULT_STEP_S
        self.cost_fit = "priors"  # what the last fit did, for logs
        self._cap_slope = None  # d(step)/d(cache slot), from warmup(fit_cap_slope=True)
        self._cost_frozen = False  # warmup() freezes the fit
        self.metrics = metrics
        self._tick = 0
        self._graph = self._decode_graph(self.cache, self.last_logits)

    @classmethod
    def for_workload(cls, model, prompts, budgets, *, max_batch, **kw):
        """An engine whose capacity is the workload's: the largest prompt
        plus budget (dead slots tax every decode step's attention)."""
        need = max(int(np.asarray(p).size) + int(b) for p, b in zip(prompts, budgets))
        return cls(model, max_batch=max_batch, max_seq_len=need, **kw)

    def _pool(self, cap):
        cache = self.model._cache(self.max_batch, cap, self._quantize, track_mask=True)
        cache["idx"] = torch.zeros((self.max_batch,), dtype=torch.int32, device=self.device)
        return cache

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _admit_group(self, rect, lengths, slots):
        """Prefill `nb` same-bucket prompts (rect Int[nb, width]) into a
        side cache and copy the rows into the pool at `slots`."""
        model, cap = self.model, self.cap
        nb = rect.shape[0]
        side = model._cache(nb, cap, self._quantize, track_mask=True)
        side["mask"] = torch.arange(cap, device=self.device)[None, :] < lengths[:, None]
        logits, side = model.core.text_forward(rect, side, prefill=True)
        last = logits[torch.arange(nb, device=self.device), lengths - 1].float()
        for kk in _KV_KEYS:
            if kk in self.cache:
                self.cache[kk].index_copy_(1, slots, side[kk])
        self.cache["mask"].index_copy_(0, slots, side["mask"])
        self.cache["idx"].index_copy_(0, slots, lengths.to(torch.int32))
        self.last_logits.index_copy_(0, slots, last)

    def _decode_graph(self, cache, last):
        """The `DecodeGraph` over a pool and its last logits (its static
        buffers from then on); the first chunk on a CUDA device captures it."""
        return DecodeGraph(self.model, cache, last, temperature=self.temperature,
                           min_p=self.min_p, eos_id=self.eos_id)

    def _run_chunk(self, graph, active, left, keys, k):
        """One chunk on `graph`'s pool: the draws (at temperature > 0), the k
        steps and the payload's one fetch. keys: (rid, count) per row, None
        for inert rows. Returns (payload numpy, the host time the fetch
        began)."""
        if graph.graph is None and self.device.type == "cuda":
            graph.capture()
        with span("transfusion.engine.decode"):
            gumbel = None
            if self.temperature > 0.0:
                gumbel = _sb._gumbel_rows(
                    self.seed, [None if key is None else (key[0], key[1] + j)
                                for j in range(k) for key in keys],
                    self.model.vocab_size, self.device, stream=_ENGINE_STREAM,
                ).view(k, len(keys), -1)
            act = torch.as_tensor(active, device=self.device)
            left = torch.as_tensor(left, dtype=torch.int32, device=self.device)
            replays = graph.replays
            payload = graph.chunk(act, left, gumbel, k=k)
            self.stats["graph_steps"] += graph.replays - replays
        t_fetch = time.perf_counter()
        with span("transfusion.engine.fetch"):
            payload = _sb._fetch(payload)
        return payload, t_fetch

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert prompt.size >= 1, "every prompt needs >= 1 token (seed with a BOS/sos token)"
        assert prompt.size + max_new_tokens <= self.cap, (
            f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds engine capacity {self.cap} — raise max_seq_len"
        )
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, int(max_new_tokens),
                                  submitted=time.perf_counter()))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def _admit_pending(self) -> tuple:
        """Pair queued requests with free rows, grouped by width bucket so
        each group prefills in one call. Returns (the admitted prompts'
        tokens, the prefills' positions, the seconds the admitted requests
        waited from submit to now)."""
        now = time.perf_counter()
        prompt_tokens = positions = 0
        queued_s = 0.0
        groups = {}
        for slot in range(self.max_batch):
            if not self.queue:
                break
            if self.active[slot]:
                continue
            r = self.queue.popleft()
            width = min(_width_bucket(r.prompt.size), self.cap)
            groups.setdefault(width, []).append((slot, r))
        for width, pairs in groups.items():
            nb = len(pairs)
            rect = np.zeros((nb, width), np.int64)
            lengths = np.zeros(nb, np.int64)
            for i, (_, r) in enumerate(pairs):
                rect[i, : r.prompt.size] = r.prompt
                lengths[i] = r.prompt.size
            with span("transfusion.engine.prefill", f"width={width} rows={nb}"):
                self._admit_group(
                    torch.as_tensor(rect, device=self.device),
                    torch.as_tensor(lengths, device=self.device),
                    torch.as_tensor([slot for slot, _ in pairs], device=self.device))
            for slot, r in pairs:
                self.slots[slot] = r
                self.active[slot] = True
                queued_s += now - r.submitted
            prompt_tokens += int(lengths.sum())
            positions += width * nb
            self.stats["admitted"] += nb
        return prompt_tokens, positions, queued_s

    def _chunk_len(self) -> int:
        """The chunk length that maximizes useful tokens per second under the
        cost model (`choose_chunk`); rows retire inside the chunk, so the
        choice trades dispatches against how long a freed row idles."""
        if not self._cost_frozen:
            _fit_cost_model(self)
        rem = [self.slots[s].max_new_tokens - len(self.slots[s].tokens)
               for s in range(self.max_batch) if self.active[s]]
        return choose_chunk(rem, self._rtt_est, self._step_est, self.decode_chunk)

    def warmup(self, fit_cap_slope: bool = True):
        """Time every power-of-two chunk length up to decode_chunk twice
        (the first run of each excluded) on inert rows, fit the cost model
        and freeze it. Inert runs leave the pool as it was: no row is active,
        so every write lands at a pinned index, masked invalid.

        fit_cap_slope: also time one chunk on a half-capacity scratch pool
        and fit d(step)/d(capacity), the basis of `static_step_at` (static
        batching decodes over exactly-sized caches). Skipped below cap 256.
        """
        inert = np.zeros(self.max_batch, bool)
        zeros = np.zeros(self.max_batch, np.int32)
        keys = [None] * self.max_batch
        k = 1
        while k <= self.decode_chunk:
            for first in (True, False):
                t0 = time.perf_counter()
                self._run_chunk(self._graph, inert, zeros, keys, k)
                if not first:
                    self._chunk_samples.setdefault(k, []).extend(
                        [0.0, time.perf_counter() - t0])
            k <<= 1
        _fit_cost_model(self)

        if fit_cap_slope and self.cap >= 256:
            half = self.cap // 2
            scratch = self._decode_graph(self._pool(half), torch.zeros_like(self.last_logits))
            k_ref = 1 << (min(self.decode_chunk, 64) - 1).bit_length()
            t_half = None
            for first in (True, False):
                t0 = time.perf_counter()
                self._run_chunk(scratch, inert, zeros, keys, k_ref)
                if not first:
                    t_half = time.perf_counter() - t0
            step_half = max((t_half - self._rtt_est) / k_ref, 1e-6)
            slope = (self._step_est - step_half) / (self.cap - half)
            # a negative slope is noise: keep None (STATIC_STEP_RATIO stands)
            self._cap_slope = slope if slope > 0 else None
            logger.info("cap slope: %s", self._cap_slope)
        self._cost_frozen = True

    def static_step_at(self, cap: int) -> Optional[float]:
        """The static path's per-token cost over an exactly-sized cache of
        `cap` slots: the fitted step less the cap slope times the dead slots
        (at least 0.2 of the step). None before warmup(fit_cap_slope=True)."""
        if self._cap_slope is None:
            return None
        est = self._step_est - self._cap_slope * max(self.cap - cap, 0)
        return max(est, 0.2 * self._step_est)

    def step(self):
        """One tick: admit queued requests into free rows, then decode one
        chunk for every active row. Returns the requests that finished."""
        with span("transfusion.engine.tick"):
            admitted_before = self.stats["admitted"]
            graph_steps_before = self.stats["graph_steps"]
            t_admit = time.perf_counter()
            with span("transfusion.engine.admit"):
                prompt_tokens, positions, queued_s = self._admit_pending()
            admit_s = time.perf_counter() - t_admit
            n_admitted = self.stats["admitted"] - admitted_before
            finished = []
            if not self.active.any():
                return finished

            with span("transfusion.engine.plan"):
                k = self._chunk_len()
            budget_left = np.zeros(self.max_batch, np.int32)
            keys = [None] * self.max_batch
            for s in range(self.max_batch):
                if self.active[s]:
                    r = self.slots[s]
                    budget_left[s] = r.max_new_tokens - len(r.tokens)
                    keys[s] = (r.rid, len(r.tokens))
            t0 = time.perf_counter()
            payload, t_fetch = self._run_chunk(self._graph, self.active, budget_left, keys, k)
            t_fetched = time.perf_counter()
            toks = payload[:, :k]
            emitted = payload[:, k : 2 * k].astype(bool)
            active_f = payload[:, -1].astype(bool)
            elapsed = time.perf_counter() - t0
            if not self._cost_frozen:  # warmup() froze the fit: no more samples
                self._chunk_samples.setdefault(k, []).append(elapsed)
            self.stats["decode_time_s"] += elapsed
            self.stats["decode_chunks"] += 1

            with span("transfusion.engine.retire"):
                emitted_total = 0
                for slot in range(self.max_batch):
                    if not self.active[slot]:
                        continue
                    r = self.slots[slot]
                    for j in range(k):
                        if not emitted[slot, j]:
                            break
                        r.tokens.append(int(toks[slot, j]))
                        self.stats["generated_tokens"] += 1
                        emitted_total += 1
                    self.active[slot] = bool(active_f[slot])
                    if not self.active[slot]:
                        r.done = True
                        finished.append(r)
                        self.slots[slot] = None

            if self.metrics is not None:
                self._tick += 1
                predicted = self._rtt_est + k * self._step_est
                self.metrics.log(self._tick, {
                    "admitted": n_admitted,
                    "retired": len(finished),
                    "chunk_k": k,
                    "chunk_seconds": elapsed,
                    "cost_model_residual_s": elapsed - predicted,
                    "emitted_tokens": emitted_total,
                    "active_slots": int(self.active.sum()),
                    "queue_depth": len(self.queue),
                    "admit_seconds": admit_s,
                    "prompt_tokens": prompt_tokens,
                    "prefill_positions": positions,
                    "queued_seconds": queued_s,
                    "dispatch_seconds": t_fetch - t0,
                    "fetch_seconds": t_fetched - t_fetch,
                    "graph_steps": self.stats["graph_steps"] - graph_steps_before,
                })
            return finished

    def serve(self, prompts, max_new_tokens):
        """Serve a batch of prompts by continuous batching or by static
        `generate_text_batch` pools, whichever `serving.plan_dispatch`
        estimates faster under the fitted cost model; one token list per
        prompt, in order. max_new_tokens: an int, or one per prompt. Both
        paths take the longest budgets first. Greedy output is the same on
        both; at temperature > 0 they draw from different streams. An empty
        batch raises ValueError, as in the JAX engine."""
        budgets = ([int(b) for b in max_new_tokens] if hasattr(max_new_tokens, "__len__")
                   else [int(max_new_tokens)] * len(prompts))
        assert len(budgets) == len(prompts)
        # static batching decodes over exactly-sized caches: its per-token
        # cost comes from the fitted cap slope (None: the ratio fallback)
        static_cap = -(-max(int(np.asarray(p).size) + b
                            for p, b in zip(prompts, budgets)) // 128) * 128
        plan = serving.plan_dispatch(
            budgets, self.max_batch, self._rtt_est, self._step_est,
            static_step_s=self.static_step_at(static_cap), max_chunk=self.decode_chunk)
        order = sorted(range(len(prompts)), key=lambda i: (-budgets[i], i))
        if plan == "static":
            out = [None] * len(prompts)
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
            for i in range(0, len(order), self.max_batch):
                idxs = order[i : i + self.max_batch]
                toks = _sb._fetch(self.model.generate_text_batch(
                    [prompts[j] for j in idxs], max_new_tokens=max(budgets[j] for j in idxs),
                    generator=generator, temperature=self.temperature, min_p=self.min_p))
                for row, j in zip(toks, idxs):
                    row = row[: budgets[j]].tolist()
                    if self.eos_id is not None and self.eos_id in row:
                        row = row[: row.index(self.eos_id) + 1]
                    out[j] = row
            return out
        rids = [None] * len(prompts)
        for i in order:
            rids[i] = self.submit(prompts[i], budgets[i])
        by_rid = {r.rid: r.tokens for r in self.run()}
        return [by_rid[rid] for rid in rids]

    def run(self, prompts=None, max_new_tokens: Optional[int] = None):
        """Drive until the queue and every row drain, after submitting
        `prompts` (each decoding `max_new_tokens`) when given. Returns the
        finished Requests in completion order."""
        if prompts is not None:
            assert max_new_tokens is not None
            for p in prompts:
                self.submit(p, max_new_tokens)
        out = []
        while self.has_work:
            out.extend(self.step())
        return out
