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

With `remat` an uncached call (training) recomputes each block's forward in
the backward instead of keeping its activations, as `nn.remat` does in the
JAX `Transformer` (`transformer.py:541-550`).
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
    AdaptiveWrapper,
    Attention,
    FeedForward,
    RMSNorm,
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

    def __init__(self, dim, dim_head, heads, ff_expansion_factor, attn_softcap,
                 attn_gate_values, attn_impl, attn_laser, fuse_projections, streams, fracs,
                 ind, is_first, has_skip):
        super().__init__()
        self.skip_proj = nn.Linear(dim * 2, dim, bias=False) if has_skip else None
        self.attn = Attention(
            dim=dim, dim_head=dim_head, heads=heads, softcap_value=attn_softcap,
            gate_values=attn_gate_values, learned_value_residual_mix=not is_first,
            attn_impl=attn_impl, laser=attn_laser, fuse_projections=fuse_projections,
        )
        self.ff = FeedForward(dim, ff_expansion_factor)
        self.attn_ada = AdaptiveWrapper(dim, dim * 4)
        self.ff_ada = AdaptiveWrapper(dim, dim * 4)
        self.hc_attn = HyperConnection(dim, streams, fracs, layer_index=2 * ind)
        self.hc_ff = HyperConnection(dim, streams, fracs, layer_index=2 * ind + 1)

    def forward(self, s, skip, cond, cond_index, mask, rope, is_any_modality,
                value_residual, layer_cache, flash_spec, decode_bias, decode_lens, prefill):
        if self.skip_proj is not None and skip is not None:
            # the projection runs in its weight's dtype (flax's Dense(dtype=)
            # casts its input); the float32 streams of a multi-stream bf16
            # model keep their dtype through the residual
            cat = torch.cat([s, skip], dim=-1)
            s = self.skip_proj(cat.to(self.skip_proj.weight.dtype)) + s
        ada = dict(cond=cond, cond_index=cond_index, is_any_modality=is_any_modality)

        branch, s_mixed = self.hc_attn(s)
        attn_out, attn_values, new_cache = self.attn_ada(
            self.attn, branch, mask=mask, rope=rope, cache=layer_cache,
            value_residual=value_residual, flash_spec=flash_spec,
            decode_bias=decode_bias, decode_lens=decode_lens, prefill=prefill, **ada,
        )
        s = self.hc_attn(s_mixed, attn_out)

        branch, s_mixed = self.hc_ff(s)
        s = self.hc_ff(s_mixed, self.ff_ada(self.ff, branch, **ada))
        return s, attn_values, new_cache


# 'dots' keeps the outputs of the unbatched matrix products (the block's
# projections) and recomputes the rest: the counterpart of
# `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
REMAT_POLICIES = ("full", "dots")


def _call_block(block, params, *args):
    return torch.func.functional_call(block, params, args)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, dim_head: int = 64, heads: int = 8,
                 ff_expansion_factor: float = 4.0, unet_skips: bool = True,
                 num_residual_streams: int = 1, attn_impl: str = "dense",
                 attn_softcap: float = 50.0, attn_gate_values: bool = True,
                 rope_theta: float = 10000.0, attn_laser: bool = False,
                 num_residual_fracs: int = 4, fuse_projections: bool = False,
                 dropout: float = 0.0, remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError(
                f"dropout={dropout}: attention/feedforward dropout is queued in "
                "ROADMAP.md (Queue 1, 'dropout'); the port trains with dropout 0"
            )
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={remat_policy!r} (one of {REMAT_POLICIES})")
        if attn_impl not in ("dense", "flash"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: context-parallel attention is "
                "queued in ROADMAP.md (Queue 1 item 9, parallelism); the port "
                "has 'dense' and 'flash'"
            )
        self.dim, self.depth = dim, depth
        self.dim_head, self.heads = dim_head, heads
        self.unet_skips = unet_skips
        self.streams = num_residual_streams
        self.attn_impl = attn_impl
        self.attn_laser = attn_laser
        self.rope_theta = rope_theta
        self.remat, self.remat_policy = remat, remat_policy
        # fixed (non-trainable) frequencies of the time embedding; from_flax
        # carries the JAX model's draw across
        self.register_buffer("fourier_weights", torch.randn(dim // 2))
        self.to_time_cond = nn.Linear(dim + 1, dim * 4)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                dim, dim_head, heads, ff_expansion_factor, attn_softcap,
                attn_gate_values, attn_impl, attn_laser, fuse_projections,
                num_residual_streams, num_residual_fracs, ind,
                is_first=ind == 0, has_skip=unet_skips and ind >= depth / 2,
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

    def _remat_block(self, block, *args):
        """block(*args) under activation checkpointing. The block runs on the
        parameter tensors it holds now, passed in explicitly: under the
        trainer's `functional_call` those are the compute-dtype casts of the
        float32 masters, which the module no longer holds when the backward
        recomputes the forward. The attention kernels' autograd Functions
        are recomputed under either policy (their launches are not aten
        products), as the Pallas calls are under `nn.remat`."""
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _DOTS_SAVED)
        return checkpoint(_call_block, block, dict(block.named_parameters()), *args,
                          use_reentrant=False, **kw)

    def _build_mask(self, n, cache, causal, spans):
        """Bool[b|1, 1, n, kv] or None."""
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
                seq = torch.arange(n)
                masks.append((seq[:, None] >= seq[None, :])[None, None])
            if spans is not None:
                masks.append(spans_to_attn_mask(n, spans)[:, None])
        if not masks:
            return None
        out = masks[0]
        for m in masks[1:]:
            out = out & m.to(out.device)
        return out

    def forward(self, x, times=None, times_inst=None, spans=None, is_any_modality=None,
                rotary_pos=None, cache: Optional[dict] = None, causal: bool = False,
                prefill: bool = False):
        """x Float[b, n, dim]: only the tokens to process (the tail when
        decoding). times Float[b] | Float[b, n] per-token conditioning, or
        times_inst Float[b, m] per span instance (needs spans). times
        Float[b] with is_any_modality=True, no spans, no cache and not
        causal is the JAX `modality_only` forward: every token conditioned
        as modality on its sample's time, dense attention with no mask.
        Returns (out, new_cache)."""
        b, n, _ = x.shape

        cond = cond_index = None
        if times_inst is not None:
            if spans is None or times is not None:
                raise ValueError("times_inst needs spans and no per-token times")
            m = times_inst.shape[1]
            inst_times = torch.cat([times_inst.new_zeros((b, 1)), times_inst], dim=1)
            rfe = random_fourier_embed(inst_times, self.dim, self.fourier_weights)
            cond = F.silu(self.to_time_cond(rfe.to(x.dtype)))
            inst_mask = spans_to_instance_mask(n, spans)  # [b, m, n]
            ids = torch.arange(1, m + 1, device=x.device)
            cond_index = (inst_mask.long() * ids[None, :, None]).sum(dim=1)
        elif times is not None:
            if times.ndim == 0:
                times = times.expand(b)
            rfe = random_fourier_embed(times, self.dim, self.fourier_weights)
            cond = F.silu(self.to_time_cond(rfe.to(x.dtype)))

        use_flash = self.attn_impl == "flash" and cache is None
        prefill_flash = prefill and cache is not None and self.attn_impl == "flash"
        flash_spec = decode_bias = decode_lens = mask = None
        if (use_flash or prefill_flash) and (spans is not None or causal):
            flash_spec = {"spans": spans, "causal": causal}
        elif self._use_decode_kernel(cache, prefill, spans, causal, n):
            cap = cache_capacity(cache)
            idx = cache["idx"]
            if "mask" in cache:
                valid = cache["mask"]
            else:
                valid = torch.arange(cap, device=x.device)[None, :] < idx.reshape(-1, 1) + n
            decode_bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32).expand(b, cap)
            decode_bias = decode_bias.contiguous()
            # per-row streaming bound idx + n covers the highest slot this
            # chunk writes; NOT sum(valid): after a padded prefill the valid
            # slots are not a prefix
            decode_lens = (idx + n).to(torch.int32).reshape(-1).expand(b).contiguous()
        else:
            mask = self._build_mask(n, cache, causal, spans)

        if is_any_modality is None and spans is not None:
            is_any_modality = spans_to_is_any_modality(n, spans)

        rope = None
        if rotary_pos is not None:
            rope = rope_angles(rotary_pos, self.dim_head, self.rope_theta)

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
                    value_residual, layer_cache, flash_spec, decode_bias, decode_lens, prefill)
            s, attn_values, _ = self._remat_block(block, *args) if remat else block(*args)
            if value_residual is None:
                value_residual = attn_values
        assert not skips

        out = self.final_norm(reduce_stream(s))
        new_cache = None
        if cache is not None:
            new_cache = {**cache, "idx": cache["idx"] + n}
        return out, new_cache
