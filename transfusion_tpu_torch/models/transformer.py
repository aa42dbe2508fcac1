"""The Transfusion transformer stack (counterpart of
`transfusion_tpu/models/transformer.py`): random-fourier time conditioning,
per-block adaLN wrappers, U-Net skips, value residual from the first layer,
multi-stream hyper-connections (`num_residual_streams`, `num_residual_fracs`;
a U-Net skip keeps the whole stream tensor), LASER attention (`attn_laser`),
one fused projection product per attention (`fuse_projections`), and a
preallocated KV cache that prefill and decode share.

Routing of a cached call (the same decisions as the JAX `Transformer`):
  * prefill (`prefill=True`, attn_impl 'flash', causal and/or spans): the
    flash kernel over the chunk alone; the cache is written;
  * a decode step whose mask reduces to per-slot validity (no spans, and
    causality only through the write index, i.e. single-token text steps or
    non-causal modality rows), in a model without LASER: the decode kernel
    over the cache, with an
    additive bias built from the cache mask and per-row bounds lens = idx + n;
  * anything else: the dense cached path with an explicit boolean mask.

With attn_impl 'ring' or 'cp_allgather' and `mesh=` (a `parallel.make_mesh`
mesh) an uncached call shards attention over the mesh's 'context' axis
(`parallel/context.py`): one with spans or causal goes to the chosen
schedule with that mask, and one with neither (the modality-only forward)
with full attention; n must be divisible by the context size, and
dropout is refused, as in JAX (`transformer.py:405-430`). Cached calls of
such a model take the dense cached path, as in JAX.

With tensor-local weights (`Trainer(mesh=)` with a 'tensor' axis) to_time_cond and
skip_proj run column-parallel and all-gather their output columns over the
axis `tp`.

With `remat` an uncached call (training) recomputes each block's forward in
the backward instead of keeping its activations, as `nn.remat` does in the
JAX `Transformer` (`transformer.py:541-550`).

Dropout (`dropout` > 0) is flax's module-level dropout: on the feedforward's
gated hidden layer and, on the dense attention path of a call without a
flash spec only, on the attention probabilities. It is live only in a call
given keep masks (`forward(dropout=)`: one {'attn', 'ff'} dict per block, or a
`torch.Generator` to draw them from), the counterpart of applying the JAX
core with `deterministic=False` and a 'dropout' rng; every other call is
deterministic. The masks are inputs of the (rematerialized) block, so a
recomputed forward uses the same ones.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from transfusion_tpu_torch.models.layers import (
    CONTEXT_PARALLEL,
    AdaptiveWrapper,
    Attention,
    FeedForward,
    RMSNorm,
    draw_keep_mask,
    random_fourier_embed,
)
from transfusion_tpu_torch.ops.decode_attn import decode_supported
from transfusion_tpu_torch.ops.hyper_connections import (
    HyperConnection,
    expand_stream,
    reduce_stream,
)
from transfusion_tpu_torch.ops.norms import NEG_INF
from transfusion_tpu_torch.ops.rope import rope_angles
from transfusion_tpu_torch.ops.spans import (
    spans_to_attn_mask,
    spans_to_instance_mask,
    spans_to_is_any_modality,
)
from transfusion_tpu_torch.parallel import comm

_logger = logging.getLogger(__name__)

CACHE_BUFFERS = ("k", "v", "k_scale", "v_scale")


def make_kv_cache(depth: int, batch: int, heads: int, max_len: int, dim_head: int,
                  dtype=torch.float32, track_mask: bool = False,
                  quantize: Optional[str] = None, device=None):
    """Preallocated KV cache for `depth` layers: K/V [depth, b, h, cap, d].

    track_mask=True adds an explicit per-slot validity mask Bool[b, cap]
    that the caller keeps current (padded prefills); without it slots below
    idx + n are valid. quantize='int8' stores K/V as int8 with a float32
    scale per (token, head), [depth, b, h, cap]."""
    shape = (depth, batch, heads, max_len, dim_head)
    cache = {"idx": torch.zeros((), dtype=torch.int32, device=device)}
    if quantize is not None:
        if quantize != "int8":
            raise ValueError(f"quantize={quantize!r} (None or 'int8')")
        for kk in ("k", "v"):
            cache[kk] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{kk}_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if track_mask:
        cache["mask"] = torch.zeros((batch, max_len), dtype=torch.bool, device=device)
    return cache


def cache_capacity(cache: dict) -> int:
    return cache["k"].shape[-2]


def cache_mark_valid(cache: dict, new_valid):
    """Mark the next chunk's slots valid: new_valid Bool[b, L] is written at
    the current idx (0-d, or Int[b] for per-row offsets). Returns a new dict
    with a new mask; call before the forward that writes those slots."""
    if "mask" not in cache:
        return cache
    b, n = new_valid.shape
    pos = cache["idx"].reshape(-1, 1) + torch.arange(n, device=new_valid.device)
    mask = cache["mask"].clone()
    mask.scatter_(1, pos.expand(b, n).long(), new_valid)
    return {**cache, "mask": mask}


class TransformerBlock(nn.Module):
    """One (skip? -> attention -> feedforward) layer over the residual
    streams s [streams, b, n, dim]. Its hyper-connections are anchored at
    layer indices 2 * ind (attention) and 2 * ind + 1 (feedforward), as in
    the JAX block."""

    tp = comm.SINGLE

    def __init__(self, dim, dim_head, heads, ff_expansion_factor, attn_softcap,
                 attn_gate_values, attn_impl, attn_laser, fuse_projections, streams, fracs,
                 ind, is_first, has_skip, dropout=0.0, mesh=None):
        super().__init__()
        self.skip_proj = nn.Linear(dim * 2, dim, bias=False) if has_skip else None
        self.attn = Attention(
            dim=dim, dim_head=dim_head, heads=heads, softcap_value=attn_softcap,
            gate_values=attn_gate_values, learned_value_residual_mix=not is_first,
            attn_impl=attn_impl, laser=attn_laser, fuse_projections=fuse_projections,
            dropout=dropout, mesh=mesh,
        )
        self.ff = FeedForward(dim, ff_expansion_factor, dropout)
        self.attn_ada = AdaptiveWrapper(dim, dim * 4)
        self.ff_ada = AdaptiveWrapper(dim, dim * 4)
        self.hc_attn = HyperConnection(dim, streams, fracs, layer_index=2 * ind)
        self.hc_ff = HyperConnection(dim, streams, fracs, layer_index=2 * ind + 1)

    def forward(self, s, skip, cond, cond_index, mask, rope, is_any_modality,
                value_residual, layer_cache, flash_spec, decode_bias, decode_lens, prefill,
                dropout_masks=None):
        if self.skip_proj is not None and skip is not None:
            # the projection runs in its weight's dtype (flax's Dense(dtype=)
            # casts its input); the float32 streams of a multi-stream bf16
            # model keep their dtype through the residual
            cat = torch.cat([s, skip], dim=-1).to(self.skip_proj.weight.dtype)
            s = _column_parallel(self.skip_proj, cat, s.shape[-1], self.tp) + s
        ada = dict(cond=cond, cond_index=cond_index, is_any_modality=is_any_modality)
        dropout_masks = dropout_masks or {}

        branch, s_mixed = self.hc_attn(s)
        attn_out, attn_values, new_cache = self.attn_ada(
            self.attn, branch, mask=mask, rope=rope, cache=layer_cache,
            value_residual=value_residual, flash_spec=flash_spec,
            decode_bias=decode_bias, decode_lens=decode_lens, prefill=prefill,
            dropout_mask=dropout_masks.get("attn"), **ada,
        )
        s = self.hc_attn(s_mixed, attn_out)

        branch, s_mixed = self.hc_ff(s)
        s = self.hc_ff(s_mixed, self.ff_ada(self.ff, branch, dropout_mask=dropout_masks.get("ff"),
                                            **ada))
        return s, attn_values, new_cache


# 'dots' keeps the outputs of the unbatched matrix products (the block's
# projections) and recomputes the rest: the counterpart of
# `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
REMAT_POLICIES = ("full", "dots")


def _column_parallel(linear, x, out_features: int, tp):
    """linear(x) when its weight holds all `out_features` rows; else this
    rank's output columns, all-gathered over `tp` (its bias sliced to
    them)."""
    rows = linear.weight.shape[0]
    if rows == out_features:
        return linear(x)
    bias = linear.bias
    if bias is not None:
        bias = bias[tp.rank * rows:(tp.rank + 1) * rows]
    return comm.gather_seq(F.linear(comm.copy_to(x, tp), linear.weight, bias), tp, dim=-1)


def _call_block(block, params, *args):
    return torch.func.functional_call(block, params, args)


class Transformer(nn.Module):
    tp = comm.SINGLE

    def __init__(self, dim: int, depth: int, dim_head: int = 64, heads: int = 8,
                 ff_expansion_factor: float = 4.0, unet_skips: bool = True,
                 num_residual_streams: int = 1, attn_impl: str = "dense",
                 attn_softcap: float = 50.0, attn_gate_values: bool = True,
                 rope_theta: float = 10000.0, attn_laser: bool = False,
                 num_residual_fracs: int = 4, fuse_projections: bool = False,
                 dropout: float = 0.0, remat: bool = False, remat_policy: str = "full",
                 mesh=None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={remat_policy!r} (one of {REMAT_POLICIES})")
        if attn_impl not in ("dense", "flash", *CONTEXT_PARALLEL):
            raise ValueError(f"attn_impl={attn_impl!r} (dense, flash, ring or cp_allgather)")
        if attn_impl in CONTEXT_PARALLEL and dropout > 0:
            raise ValueError(
                f"attn_impl='{attn_impl}' does not implement attention dropout (the ring / "
                "all-gather schedules have no dropout hook): set dropout=0 or use the dense "
                "or flash path")
        self.mesh = mesh
        self.dim, self.depth = dim, depth
        self.dim_head, self.heads = dim_head, heads
        self.unet_skips = unet_skips
        self.streams = num_residual_streams
        self.attn_impl = attn_impl
        self.attn_laser = attn_laser
        self.rope_theta = rope_theta
        self.remat, self.remat_policy = remat, remat_policy
        self.dropout = dropout
        # fixed (non-trainable) frequencies of the time embedding; from_flax
        # carries the JAX model's draw across
        self.register_buffer("fourier_weights", torch.randn(dim // 2))
        self.to_time_cond = nn.Linear(dim + 1, dim * 4)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                dim, dim_head, heads, ff_expansion_factor, attn_softcap,
                attn_gate_values, attn_impl, attn_laser, fuse_projections,
                num_residual_streams, num_residual_fracs, ind,
                is_first=ind == 0, has_skip=unet_skips and ind >= depth / 2, dropout=dropout,
                mesh=mesh,
            )
            for ind in range(depth)
        )
        self.final_norm = RMSNorm(dim)

    def _use_decode_kernel(self, cache, prefill, spans, causal, n):
        """A cached step goes to the decode kernel when its mask reduces to
        per-slot validity and the model is not LASER (the kernel reads v
        itself, not exp(v)). Exclusions are logged so a silently dense
        serving path is visible."""
        if cache is None or prefill or self.attn_impl != "flash":
            return False

        def excluded(why):
            _logger.info("decode kernel excluded for this cached step (%s) — "
                         "falling back to the dense cached path", why)
            return False

        if self.attn_laser:
            return excluded("LASER attention")
        if spans is not None:
            return excluded("structural span/attention mask")
        if causal and n != 1:
            return excluded(f"multi-token causal chunk (n={n})")
        return decode_supported(self.dim_head, n)

    def _remat_block(self, block, *args, params: Optional[dict] = None):
        """block(*args) under activation checkpointing. The block runs on the
        parameter tensors it holds now (or on `params`), passed in
        explicitly: under the trainer's `functional_call` those are the
        compute-dtype casts of the float32 masters, which the module no
        longer holds when the backward recomputes the forward. The attention
        kernels' autograd Functions are recomputed under either policy
        (their launches are not aten products), as the Pallas calls are
        under `nn.remat`."""
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _DOTS_SAVED)
        if params is None:
            params = dict(block.named_parameters())
        return checkpoint(_call_block, block, params, *args, use_reentrant=False, **kw)

    def _flash_spec(self, spans, causal, cache, prefill):
        """The flash kernel's mask spec for a call, or None when the call
        does not go to the flash kernel. A context-parallel model's
        uncached calls all take one: with neither spans nor causal it is
        the modality-only path's full attention (JAX's `fused_nomask`)."""
        cp = self.attn_impl in CONTEXT_PARALLEL and cache is None
        flash = (self.attn_impl == "flash" and (cache is None or prefill)) or cp
        if flash and (spans is not None or causal or cp):
            return {"spans": spans, "causal": causal}
        return None

    def draw_dropout_masks(self, generator: torch.Generator, b: int, n: int, spans=None,
                           causal: bool = False, cache: Optional[dict] = None,
                           prefill: bool = False, device=None) -> list:
        """The keep masks that `forward(dropout=generator)` draws for a call
        on b x n tokens with these spans / causal / cache / prefill: one
        {'attn': Bool[b, h, n, kv] | None, 'ff': Bool[b, n, ff_inner]} dict
        per block (None entries where nothing is dropped), drawn block by
        block, attention before feedforward, on `device` (default the
        model's). The attention mask is drawn only when the call's
        attention is the dense path without a flash spec, the only one that
        drops (the JAX module's einsum path). Draw them on one device and
        move them to replay the same call elsewhere."""
        if self.dropout == 0.0:
            return [None] * self.depth
        device = self.fourier_weights.device if device is None else device
        drop_attn = self._flash_spec(spans, causal, cache, prefill) is None and not (
            self._use_decode_kernel(cache, prefill, spans, causal, n))
        kv = n if cache is None else cache_capacity(cache)
        masks = []
        for block in self.blocks:
            attn = None
            if drop_attn:
                attn = draw_keep_mask((b, self.heads, n, kv), self.dropout, generator, device)
            ff = draw_keep_mask((b, n, block.ff.dim_inner), self.dropout, generator, device)
            masks.append({"attn": attn, "ff": ff})
        return masks

    def _build_mask(self, n, cache, causal, spans, device):
        """Bool[b|1, 1, n, kv] on `device`, or None."""
        masks = []
        if cache is not None:
            cap = cache_capacity(cache)
            idx_b = cache["idx"].reshape(-1, 1)
            kv_pos = torch.arange(cap, device=idx_b.device)
            if "mask" in cache:
                valid = cache["mask"]
            else:
                valid = kv_pos[None, :] < idx_b + n
            masks.append(valid[:, None, None, :])
            if causal:
                q_pos = idx_b + torch.arange(n, device=idx_b.device)  # [b|1, n]
                masks.append((q_pos[:, :, None] >= kv_pos[None, None, :])[:, None])
            if spans is not None:
                m = spans_to_attn_mask(n, spans)
                masks.append(F.pad(m, (0, cap - n))[:, None])
        else:
            if causal:
                seq = torch.arange(n, device=device)
                masks.append((seq[:, None] >= seq[None, :])[None, None])
            if spans is not None:
                masks.append(spans_to_attn_mask(n, spans)[:, None])
        if not masks:
            return None
        out = masks[0]
        for m in masks[1:]:
            out = out & m.to(out.device)
        return out

    def _time_cond(self, x, times, times_inst, spans):
        """(cond, cond_index): the time conditioning of a call on x [b, n,
        dim], per span instance (times_inst Float[b, m], cond [b, m + 1, 4
        dim] and the instance of each token, 0 for text) or per token or
        sample (times), or (None, None) without times."""
        b, n, _ = x.shape
        if times_inst is not None:
            if spans is None or times is not None:
                raise ValueError("times_inst needs spans and no per-token times")
            m = times_inst.shape[1]
            inst_times = torch.cat([times_inst.new_zeros((b, 1)), times_inst], dim=1)
            rfe = random_fourier_embed(inst_times, self.dim, self.fourier_weights)
            cond = F.silu(_column_parallel(self.to_time_cond, rfe.to(x.dtype), self.dim * 4,
                                           self.tp))
            inst_mask = spans_to_instance_mask(n, spans)  # [b, m, n]
            ids = torch.arange(1, m + 1, device=x.device)
            return cond, (inst_mask.long() * ids[None, :, None]).sum(dim=1)
        if times is not None:
            if times.ndim == 0:
                times = times.expand(b)
            rfe = random_fourier_embed(times, self.dim, self.fourier_weights)
            return F.silu(_column_parallel(self.to_time_cond, rfe.to(x.dtype), self.dim * 4,
                                           self.tp)), None
        return None, None

    def trunk_inputs(self, x, times=None, times_inst=None, spans=None, causal: bool = False,
                     is_any_modality=None, rotary_pos=None) -> dict:
        """What the blocks of an uncached call take besides the stream, as
        `forward` builds it (the JAX `prepare_trunk_inputs`,
        `parallel/pipeline.py:365-461`): cond / cond_index, the dense mask
        or the flash spec, rope angles and the modality flags (Bool[b, n],
        or one bool for every token). `forward` builds its uncached calls'
        inputs here; the pipeline engines compute them once, replicated, and
        index them per microbatch."""
        n = x.shape[1]
        cond, cond_index = self._time_cond(x, times, times_inst, spans)
        flash_spec = self._flash_spec(spans, causal, None, False)
        mask = None if flash_spec is not None else self._build_mask(n, None, causal, spans,
                                                                      x.device)
        if is_any_modality is None and spans is not None:
            is_any_modality = spans_to_is_any_modality(n, spans)
        rope = None if rotary_pos is None else rope_angles(rotary_pos, self.dim_head,
                                                           self.rope_theta)
        return dict(cond=cond, cond_index=cond_index, mask=mask, rope=rope,
                    is_any_modality=is_any_modality, flash_spec=flash_spec)

    def run_stage(self, x, values, layers, params: list, inputs: dict):
        """Blocks `layers` (a contiguous range) of a single-stream stack on
        x [b, n, dim]: one pipeline stage (`parallel/pipeline.py`). values:
        the first layer's attention values, or None when `layers` starts
        at layer 0, which makes them. params[i]: block i's parameters (a
        dict by the block's own names). inputs: `trunk_inputs` for these
        rows. Each block is rematerialized under `remat` when grad is on.
        Returns (x, values)."""
        remat = self.remat and torch.is_grad_enabled()
        for ind in layers:
            block = self.blocks[ind]
            args = (x[None], None, inputs["cond"], inputs["cond_index"], inputs["mask"],
                    inputs["rope"], inputs["is_any_modality"], values, None,
                    inputs["flash_spec"], None, None, False, None)
            if remat:
                s, attn_values, _ = self._remat_block(block, *args, params=params[ind])
            else:
                s, attn_values, _ = _call_block(block, params[ind], *args)
            x = s[0]
            if values is None:
                values = attn_values
        return x, values

    def forward(self, x, times=None, times_inst=None, spans=None, is_any_modality=None,
                rotary_pos=None, cache: Optional[dict] = None, causal: bool = False,
                prefill: bool = False, dropout=None):
        """x Float[b, n, dim]: only the tokens to process (the tail when
        decoding). times Float[b] | Float[b, n] per-token conditioning, or
        times_inst Float[b, m] per span instance (needs spans). times
        Float[b] with is_any_modality=True, no spans, no cache and not
        causal is the JAX `modality_only` forward: every token conditioned
        as modality on its sample's time, dense attention with no mask.
        `dropout`: None (deterministic), a list of one {'attn': Bool[b, h,
        n, kv] | None, 'ff': Bool[b, n, ff_inner] | None} keep-mask dict per
        block, or a torch.Generator to draw them from. Returns (out,
        new_cache)."""
        b, n, _ = x.shape
        if self.attn_impl in CONTEXT_PARALLEL and cache is None:
            if self.mesh is None:
                raise ValueError(f"attn_impl='{self.attn_impl}' needs a mesh with a 'context' "
                                 "axis: pass mesh= in the transformer config "
                                 "(parallel.make_mesh(context=...))")
            from transfusion_tpu_torch.parallel.mesh import axis_size

            csize = axis_size(self.mesh, "context")
            if n % csize:
                raise ValueError(f"attn_impl='{self.attn_impl}': sequence length {n} must be "
                                 f"divisible by the context axis size {csize}: pick a "
                                 "pad_multiple divisible by it")

        decode_bias = decode_lens = None
        if cache is None:
            inputs = self.trunk_inputs(x, times, times_inst, spans, causal, is_any_modality,
                                       rotary_pos)
            cond, cond_index, mask, rope, is_any_modality, flash_spec = (
                inputs[k] for k in ("cond", "cond_index", "mask", "rope", "is_any_modality",
                                    "flash_spec"))
        else:
            cond, cond_index = self._time_cond(x, times, times_inst, spans)
            flash_spec = self._flash_spec(spans, causal, cache, prefill)
            mask = None
            if flash_spec is None and self._use_decode_kernel(cache, prefill, spans, causal, n):
                cap = cache_capacity(cache)
                idx = cache["idx"]
                if "mask" in cache:
                    valid = cache["mask"]
                else:
                    valid = (torch.arange(cap, device=x.device)[None, :]
                             < idx.reshape(-1, 1) + n)
                decode_bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32).expand(b, cap)
                decode_bias = decode_bias.contiguous()
                # per-row streaming bound idx + n covers the highest slot this
                # chunk writes; NOT sum(valid): after a padded prefill the valid
                # slots are not a prefix
                decode_lens = (idx + n).to(torch.int32).reshape(-1).expand(b).contiguous()
            elif flash_spec is None:
                mask = self._build_mask(n, cache, causal, spans, x.device)
            if is_any_modality is None and spans is not None:
                is_any_modality = spans_to_is_any_modality(n, spans)
            rope = None
            if rotary_pos is not None:
                rope = rope_angles(rotary_pos, self.dim_head, self.rope_theta)

        dropout_masks = [None] * self.depth
        if dropout is not None and self.dropout > 0.0:
            if isinstance(dropout, torch.Generator):
                dropout = self.draw_dropout_masks(dropout, b, n, spans, causal, cache, prefill,
                                                  x.device)
            if len(dropout) != self.depth:
                raise ValueError(f"{len(dropout)} dropout mask dicts for {self.depth} blocks")
            dropout_masks = list(dropout)

        s = expand_stream(x, self.streams)
        skips = []
        value_residual = None
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for ind, block in enumerate(self.blocks):
            layer = ind + 1
            if self.unet_skips and layer <= self.depth // 2:
                skips.append(s)
            skip = skips.pop() if block.skip_proj is not None else None

            layer_cache = None
            if cache is not None:
                layer_cache = {kk: cache[kk][ind] for kk in CACHE_BUFFERS if kk in cache}
                layer_cache["idx"] = cache["idx"]

            args = (s, skip, cond, cond_index, mask, rope, is_any_modality,
                    value_residual, layer_cache, flash_spec, decode_bias, decode_lens, prefill,
                    dropout_masks[ind])
            s, attn_values, _ = self._remat_block(block, *args) if remat else block(*args)
            if value_residual is None:
                value_residual = attn_values
        assert not skips

        out = self.final_norm(reduce_stream(s))
        new_cache = None
        if cache is not None:
            new_cache = {**cache, "idx": cache["idx"] + n}
        return out, new_cache
