"""The Transfusion model (counterpart of `transfusion_tpu/models/transfusion.py`).

  * `TransfusionCore` (nn.Module): transformer + text embedding + logits
    head + per-modality latent <-> model projections (the default linear
    ones, or a `pre_post_transformer_enc_dec` pair such as a U-Net's halves)
    + the axial positional-embedding MLPs, with the entry points
    `joint` (the packed forward: training, uncached sampling, or the cached
    prefill), `decode_text_step`, `decode_modality_rows`, `text_forward`
    and `modality_forward`.
  * `Transfusion` (plain class): configuration, vocab layout, packing, the
    joint training loss (`loss`, `_loss_impl`), the text-only and
    modality-only forwards (`forward_text`, `forward_modality`, `forward`),
    the frozen modality encoders / decoders (`encode_modalities`,
    `decode_modalities`) and the host-side serving loops — `generate_text_only`,
    `generate_text_batch`, `generate_modality_only`, `sample` (uncached, or
    `cache_kv=True` with incremental CFG) and `sample_batch`
    (`models/sample_batch.py`).

The port holds its serving weights in the modules; load the JAX package's
weights with `Transfusion.load_flax`. The loss can also run on an explicit
parameter dict (float32 master weights, `training/trainer.py`), which it
casts to the compute dtype inside the graph, as flax's `dtype=` does with
float32 params. Randomness comes in as explicit draws (`LossDraws`) or
from a caller-owned `torch.Generator`. Entry points run on `cuda` unless
built with `device="cpu"`.

The joint loss has the JAX package's velocity-consistency term (an EMA
forward at t + delta, `loss(velocity_consistency_ema_params=)`) and its
reconstruction term (`reconstruction_loss_weight`). Dropout is the JAX
package's: module-level, live only where the core is applied with keep
masks (`TransfusionCore.joint(dropout=)` etc.); every sampler and
`loss(train=False)` run without it, and `loss(train=True)` with dropout > 0
is refused, as flax refuses it there for want of a 'dropout' rng.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import logging
import math
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from transfusion_tpu_torch.data.packing import (
    ModalityPackSpec,
    PackSpec,
    apply_modality_fn,
    normalize_sample,
    pack_samples,
    to_channel_last,
    to_user_layout,
)
from transfusion_tpu_torch.models import sample_batch as _sample_batch
from transfusion_tpu_torch.models.serving import plan_serving
from transfusion_tpu_torch.models.transformer import (
    Transformer,
    cache_mark_valid,
    make_kv_cache,
)
from transfusion_tpu_torch.ops.axial import ContinuousAxialPositionalEmbedding
from transfusion_tpu_torch.ops.flow import (
    gumbel_sample,
    min_p_filter,
    model_output_to_flow,
    noise_data,
)
from transfusion_tpu_torch.ops.norms import max_neg_value
from transfusion_tpu_torch.ops.odeint import odeint
from transfusion_tpu_torch.ops.spans import (
    spans_to_is_any_modality,
    spans_to_modality_mask,
    spans_to_rotary_positions,
)
from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.pipeline import pipeline_transformer_forward
from transfusion_tpu_torch.utils.helpers import (
    cast_tuple,
    concat_contiguous_text,
    decode_chars,
    default,
    resolve_device,
    round_up_to_multiple,
    tokens_since_rightmost_id,
)

logger = logging.getLogger("transfusion_tpu_torch")


def default_to_modality_shape_fn(s: str) -> tuple:
    return tuple(int(x) for x in s.split(","))


class LossBreakdown(NamedTuple):
    total: Any
    text: Any
    flow: list
    velocity: Optional[list] = None
    recon: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class LossDraws:
    """The random draws of one joint-loss evaluation, made by the caller:
    times Float[b, m] per span instance, cfg_uniform Float[b] (a sample's
    text is dropped to null where it is < prob_uncond), one noise tensor
    per latent group, shaped like the group's latents, and, for the
    velocity-consistency term, the EMA forward's own noise per group (the
    JAX package's `rng_noise_ema` split)."""

    times: Any
    cfg_uniform: Any
    noises: tuple
    ema_noises: tuple = ()


def default_modality_times(u_count, u_time, num_modalities, m: int):
    """The JAX `default_modality_times` from its two uniform draws Float[b]:
    a random count floor(u_count * num_modalities) of 'already decoded'
    instances is pinned at time 0.5; the rest share the time u_time."""
    rand_num = torch.floor(u_count * num_modalities.to(torch.float32))
    prev_decoded = torch.arange(m, device=u_count.device)[None, :] < rand_num[:, None]
    return torch.where(prev_decoded, 0.5, u_time[:, None])


@dataclasses.dataclass(frozen=True)
class ModalityConfig:
    dim_latent: int
    channel_first_latent: bool = False
    add_pos_emb: bool = False
    num_dim: Optional[int] = None
    default_shape: Optional[tuple] = None
    to_shape_fn: Callable = default_to_modality_shape_fn


class LatentToModel(nn.Module):
    def __init__(self, dim: int, dim_latent: int):
        super().__init__()
        self.proj = nn.Linear(dim_latent, dim) if dim_latent != dim else None

    def forward(self, x):
        return x if self.proj is None else self.proj(x.to(self.proj.weight.dtype))


class ModelToLatent(nn.Module):
    def __init__(self, dim: int, dim_latent: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_latent, bias=False)

    def forward(self, x):
        return self.proj(x.to(self.proj.weight.dtype))


class TransfusionCore(nn.Module):
    """Transformer + embeddings + modality projections + axial pos-emb
    MLPs. `pre_post[i]`, when given, is modality i's (pre, post) module
    pair; it replaces `LatentToModel` / `ModelToLatent` and trains with the
    core. `pos_emb_mlps` holds an MLP under str(i) for each modality with
    add_pos_emb.

    With tensor-local weights (`Trainer(mesh=)` with a 'tensor' axis) the
    vocab is split over the axis `tp`: `embed_text` looks up the rank's
    rows and sums over the axis, `text_logits` all-gathers the rank's logit
    columns (the whole [.., vocab] logits are then on every rank, so the
    loss's log-softmax and the chunked CE need no further collective)."""

    tp = comm.SINGLE

    def __init__(self, vocab_size: int, dim: int, transformer_cfg: dict, modalities: tuple,
                 pre_post: tuple = (), model_output_clean: bool = True, eps: float = 1e-2):
        super().__init__()
        self.model_output_clean = model_output_clean
        self.eps = eps
        self.transformer = Transformer(dim=dim, **transformer_cfg)
        self.text_embed = nn.Embedding(vocab_size, dim)
        self.to_text_logits = nn.Linear(dim, vocab_size, bias=False)
        pre_post = tuple(pre_post) + (None,) * (len(modalities) - len(pre_post))
        self.latent_to_model = nn.ModuleList(
            LatentToModel(dim, mc.dim_latent) if pp is None else pp[0]
            for mc, pp in zip(modalities, pre_post))
        self.model_to_latent = nn.ModuleList(
            ModelToLatent(dim, mc.dim_latent) if pp is None else pp[1]
            for mc, pp in zip(modalities, pre_post))
        self.pos_emb_mlps = nn.ModuleDict()
        for i, mc in enumerate(modalities):
            if mc.add_pos_emb:
                if mc.num_dim is None:
                    raise ValueError(f"set modality_num_dim for modality {i} to use axial "
                                     "positional embeddings")
                self.pos_emb_mlps[str(i)] = ContinuousAxialPositionalEmbedding(dim, mc.num_dim)

    @property
    def dtype(self):
        return self.to_text_logits.weight.dtype

    def forward(self, *args, method: str = "joint", **kwargs):
        """Run the entry point `method` (by default `joint`, the uncached
        joint forward of training). It is the module's forward so that
        `torch.func.functional_call` can run any entry point on an explicit
        parameter dict."""
        return getattr(self, method)(*args, **kwargs)

    def text_logits(self, embed):
        """The logits head, in the compute dtype (a multi-stream bf16
        model's transformer output is float32, as in flax)."""
        return self.logits_with(embed, self.to_text_logits.weight)

    def logits_with(self, embed, weight):
        """embed's logits under `weight` (the head's, or an explicit copy of
        it), in weight's dtype; vocab-parallel on a tensor-local weight."""
        x = embed.to(weight.dtype)
        if weight.shape[0] == self.text_embed.num_embeddings:
            return F.linear(x, weight)
        return comm.gather_seq(F.linear(comm.copy_to(x, self.tp), weight), self.tp, dim=-1)

    def embed_text(self, text):
        ids, w = text.clamp_min(0), self.text_embed.weight
        if w.shape[0] == self.text_embed.num_embeddings:
            return F.embedding(ids, w).to(self.dtype)
        local = ids - self.tp.rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(local.clamp(0, w.shape[0] - 1), w) * inside[..., None].to(w.dtype)
        return comm.reduce_from(rows, self.tp).to(self.dtype)

    def latent_to_seq(self, latents, modality_type: int):
        """[k, *latent_shape, d_latent] -> rows [k, L, dim] (+ seq shape),
        as the projection gives them: without the position embedding and
        not cast (the x -> flow conversion reads these rows)."""
        out = self.latent_to_model[modality_type](latents)
        seq_shape = tuple(out.shape[1:-1])
        return out.reshape(out.shape[0], -1, out.shape[-1]), seq_shape

    def seq_to_latent(self, rows, modality_type: int, seq_shape: tuple):
        """rows [k, L, dim] -> float32 [k, *latent_shape, d_latent]."""
        x = rows.reshape(rows.shape[0], *seq_shape, rows.shape[-1])
        return self.model_to_latent[modality_type](x).to(torch.float32)

    def axial_pos_emb(self, modality_type: int, seq_shape: tuple):
        """The axial position embedding [L, dim] of a seq shape, or None."""
        if str(modality_type) not in self.pos_emb_mlps:
            return None
        mlp = self.pos_emb_mlps[str(modality_type)]
        coords = ContinuousAxialPositionalEmbedding.coords_for_shape(
            seq_shape, mlp.num_axial_dims, device=mlp.layers[0].weight.device)
        return mlp(coords)

    def input_rows(self, rows, modality_type: int, seq_shape: tuple):
        """The transformer's input rows of a modality: the projected rows
        plus the position embedding, added in float32, then cast to the
        compute dtype."""
        pos = self.axial_pos_emb(modality_type, seq_shape)
        if pos is not None:
            rows = rows.to(torch.float32) + pos.to(torch.float32)
        return rows.to(self.dtype)

    # -- joint packed forward (cached prefill) --------------------------------

    def joint_embed_in(self, packed):
        text, spans = packed.text, packed.spans
        n = text.shape[1]
        x = self.embed_text(text)
        group_rows = []
        for g in packed.groups:
            rows, seq_shape = self.latent_to_seq(g.latents, g.modality_type)
            if seq_shape != tuple(g.seq_shape):
                raise ValueError(f"latent_to_model gave seq shape {seq_shape}; the packer "
                                 f"assumed {g.seq_shape} for modality {g.modality_type}")
            group_rows.append(rows)
            idx = g.offsets[:, None] + torch.arange(g.seq_len, device=x.device)[None, :]
            x[g.batch_idx[:, None], idx] = self.input_rows(rows, g.modality_type, seq_shape)
        return x, spans_to_rotary_positions(n, spans), group_rows

    def joint_out(self, embed, packed, times, group_rows, return_logits: bool = True):
        logits = self.text_logits(embed) if return_logits else None
        pred_flows = []
        for g, noised_rows in zip(packed.groups, group_rows):
            idx = g.offsets[:, None] + torch.arange(g.seq_len, device=embed.device)[None, :]
            out_rows = embed[g.batch_idx[:, None], idx]
            if self.model_output_clean:
                t_inst = times[g.batch_idx, g.span_rows]
                out_rows = model_output_to_flow(out_rows, noised_rows, t_inst, self.eps)
            pred_flows.append(self.seq_to_latent(out_rows, g.modality_type, g.seq_shape))
        return logits, pred_flows

    def trunk_inputs(self, x, **kwargs) -> dict:
        """The transformer's `trunk_inputs` (an entry point, so that
        `functional_call` runs it on an explicit parameter dict)."""
        return self.transformer.trunk_inputs(x, **kwargs)

    def joint(self, packed, times, cache: Optional[dict] = None, return_logits: bool = True,
              dropout=None, pipeline=None):
        """Forward a packed (torch) batch; times Float[b, m]. With a cache
        this is the cached prefill: attention runs over the chunk alone
        through the flash kernel and the cache is written. `dropout`: the
        transformer's keep masks or a generator for them (`Transformer.
        forward`); None is deterministic. `pipeline`: (a mesh with a 'pipe'
        axis or `parallel.pipeline.LocalStages`, microbatches) runs the
        transformer on the GPipe schedule (`parallel/pipeline.py`);
        embed-in and the out-projections stay whole. Returns (logits |
        None, embed, pred_flows, group_rows, new_cache)."""
        x, rotary_pos, group_rows = self.joint_embed_in(packed)
        if pipeline is not None:
            embed = pipeline_transformer_forward(self.transformer, *pipeline, x, times_inst=times,
                                                 spans=packed.spans, rotary_pos=rotary_pos)
            new_cache = None
        else:
            embed, new_cache = self.transformer(
                x, times_inst=times, spans=packed.spans, rotary_pos=rotary_pos,
                cache=cache, prefill=cache is not None, dropout=dropout,
            )
        logits, pred_flows = self.joint_out(embed, packed, times, group_rows, return_logits)
        return logits, embed, pred_flows, group_rows, new_cache

    # -- cached decode steps ---------------------------------------------------

    def decode_text_step(self, tok, rotary_pos, cache):
        """One cached text step; tok Int[b, L] (usually L = 1)."""
        b, L = tok.shape
        x = self.embed_text(tok)
        times_tok = torch.zeros((b, L), dtype=torch.float32, device=x.device)
        embed, new_cache = self.transformer(
            x, times=times_tok, rotary_pos=rotary_pos, cache=cache, is_any_modality=False,
        )
        return self.text_logits(embed), new_cache

    def decode_modality_rows(self, latents, t, rotary_pos, cache, modality_type: int):
        """Cached forward of one modality's rows (the ODE tail). latents
        [b, *latent_shape, d]; t a scalar (or Float[b]). Returns
        (pred_flow_latents, new_cache)."""
        rows, seq_shape = self.latent_to_seq(latents, modality_type)
        b, L, _ = rows.shape
        t_arr = torch.as_tensor(t, dtype=torch.float32).to(rows.device)
        times_row = t_arr.reshape(-1).expand(b)
        times_tok = times_row[:, None].expand(b, L)
        embed, new_cache = self.transformer(
            self.input_rows(rows, modality_type, seq_shape), times=times_tok,
            rotary_pos=rotary_pos, cache=cache, is_any_modality=True,
        )
        out_rows = embed
        if self.model_output_clean:
            out_rows = model_output_to_flow(out_rows, rows, times_row, self.eps)
        return self.seq_to_latent(out_rows, modality_type, seq_shape), new_cache

    def text_forward(self, text, cache=None, rotary_pos=None, prefill: bool = False,
                     dropout=None):
        """Causal LM forward of the chunk `text` Int[b, n]. rotary_pos
        defaults to arange(n); pass absolute positions when decoding.
        `dropout` as in `joint`."""
        n = text.shape[1]
        if rotary_pos is None:
            rotary_pos = torch.arange(n, device=text.device)
        embed, new_cache = self.transformer(
            self.embed_text(text), causal=True, rotary_pos=rotary_pos,
            cache=cache, prefill=prefill, dropout=dropout,
        )
        return self.text_logits(embed), new_cache

    def modality_forward(self, noised, times, modality_type: int, dropout=None):
        """The flow-matching forward of one modality alone (JAX
        `modality_forward`, `transfusion.py:392-407`): noised Float[b,
        *latent_shape, d_latent] channel-last, times Float[b]; every token
        is conditioned as modality on its sample's time. Returns the model's
        output in latent space (float32); the caller turns an x-prediction
        into a flow.

        Attention here is dense and unmasked. The JAX transformer gives a
        modality-only call neither a flash spec nor a decode bias and runs
        XLA's einsum attention, no Pallas kernel, so the port's dense path
        is its counterpart, not a fallback from a kernel. `dropout` as in
        `joint`."""
        rows, seq_shape = self.latent_to_seq(noised, modality_type)
        embed, _ = self.transformer(self.input_rows(rows, modality_type, seq_shape),
                                    times=times, is_any_modality=True, dropout=dropout)
        return self.seq_to_latent(embed, modality_type, seq_shape)


def _ce_chunk_sum(core, embed, weight, labels, valid):
    """-sum log p(label) over the valid positions of one sequence chunk
    (one step of the JAX `_chunked_ce` scan): the chunk's logits live only
    inside this call."""
    logits = core.logits_with(embed, weight).float()
    label_logit = logits.gather(-1, labels[..., None])[..., 0]
    return (-(label_logit - torch.logsumexp(logits, dim=-1)) * valid).sum()


def _frozen(module: nn.Module, state_dict, device):
    """A private copy of an encoder / decoder (with `state_dict` loaded
    when given) on `device`, in eval mode, with no parameter to train."""
    module = copy.deepcopy(module)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    return module.to(device).eval().requires_grad_(False)


class Transfusion:
    """Configuration + host-side serving loops around a `TransfusionCore`.

    The constructor mirrors the JAX package's kwargs. `dtype` is the
    compute and weight dtype (bf16 on the card; the modality projections
    and pos-emb MLPs stay float32, as flax computes them); the weights come
    from torch's default init under `seed` (a `pre_post_transformer_enc_dec`
    module keeps the weights it was built with), or from the JAX package
    through `load_flax`.

    `modality_encoder` / `modality_decoder`: a module, a per-modality list
    (None where a modality has none) or a (module, state_dict) pair, which
    take and give batches in the user's layout, as the JAX package's do;
    the model keeps frozen copies (eval, no grad) on its device.
    `pre_post_transformer_enc_dec`: a (pre, post) pair of modules, or one
    per modality; the model keeps its own copies, which train with it."""

    def __init__(self, *, num_text_tokens: int, transformer: dict, dim_latent=None,
                 channel_first_latent=False, add_pos_emb=False, modality_encoder=None,
                 modality_decoder=None, pre_post_transformer_enc_dec=None,
                 modality_default_shape=None, fallback_to_default_shape_if_invalid: bool = False,
                 modality_num_dim=None, to_modality_shape_fn=default_to_modality_shape_fn,
                 ignore_index: int = -1, flow_loss_weight: float = 1.0,
                 text_loss_weight: float = 1.0, velocity_consistency_loss_weight: float = 0.1,
                 reconstruction_loss_weight: float = 0.0,
                 odeint_method: str = "midpoint", model_output_clean: bool = True,
                 eps: float = 1e-2, prob_uncond: float = 0.1, pad_multiple: int = 64,
                 ce_chunk_size: Optional[int] = None, dtype=torch.float32,
                 device=None, seed: int = 0):
        if ce_chunk_size is not None and ce_chunk_size < 1:
            raise ValueError(f"ce_chunk_size={ce_chunk_size} (None or a positive int)")
        self.device = resolve_device(device)
        self.dtype = dtype

        transformer = dict(transformer)
        self.dim = transformer.pop("dim")
        self.transformer_cfg = transformer

        dim_latent = default(dim_latent, self.dim)
        self.dim_latents = cast_tuple(dim_latent)
        T = self.num_modalities = len(self.dim_latents)
        channel_first = cast_tuple(channel_first_latent, T)
        add_pos = cast_tuple(add_pos_emb, T)
        to_shape_fns = cast_tuple(to_modality_shape_fn, T)
        if modality_default_shape is None or (
            isinstance(modality_default_shape, tuple)
            and all(isinstance(x, int) for x in modality_default_shape)
        ):
            modality_default_shape = (modality_default_shape,) * T
        self.modality_default_shape = modality_default_shape
        if modality_num_dim is None:
            modality_num_dim = tuple(
                len(s) if s is not None else None for s in modality_default_shape
            )
        num_dims = cast_tuple(modality_num_dim, T)
        self.modalities = tuple(
            ModalityConfig(
                dim_latent=self.dim_latents[i], channel_first_latent=channel_first[i],
                add_pos_emb=bool(add_pos[i]), num_dim=num_dims[i],
                default_shape=modality_default_shape[i], to_shape_fn=to_shape_fns[i],
            )
            for i in range(T)
        )

        # token id layout (as the JAX package)
        self.num_text_tokens = num_text_tokens
        self.sos_id = num_text_tokens
        self.eos_id = num_text_tokens + 1
        self.null_text_id = num_text_tokens + 2
        self.som_ids = [num_text_tokens + 3 + i for i in range(T)]
        self.eom_ids = [num_text_tokens + 3 + T + i for i in range(T)]
        self.meta_id = num_text_tokens + 3 + 2 * T
        self.char_offset = self.meta_id + 1
        self.vocab_size = num_text_tokens + 3 + 2 * T + 129

        # encoders / decoders: frozen, outside the core's parameters
        self.encoders = self._norm_aux(modality_encoder)
        self.decoders = self._norm_aux(modality_decoder)
        # pre/post transformer projections: learnable, inside the core
        pp = pre_post_transformer_enc_dec
        if pp is None:
            pp = ()
        elif isinstance(pp, tuple) and len(pp) == 2 and isinstance(pp[0], nn.Module):
            pp = (pp,)
        self.pre_post = tuple(None if x is None else tuple(copy.deepcopy(m) for m in x)
                              for x in pp) + (None,) * (T - len(pp))
        self._seq_shape_cache: dict = {}

        self.odeint_method = odeint_method
        self.fallback_to_default_shape_if_invalid = fallback_to_default_shape_if_invalid
        self.pad_multiple = pad_multiple
        self.ignore_index = ignore_index
        self.flow_loss_weight = flow_loss_weight
        self.text_loss_weight = text_loss_weight
        self.velocity_consistency_loss_weight = velocity_consistency_loss_weight
        self.reconstruction_loss_weight = reconstruction_loss_weight
        self.has_recon_loss = reconstruction_loss_weight > 0.0
        self.prob_uncond = prob_uncond
        self.ce_chunk_size = ce_chunk_size

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            core = TransfusionCore(
                vocab_size=self.vocab_size, dim=self.dim,
                transformer_cfg=self.transformer_cfg, modalities=self.modalities,
                pre_post=self.pre_post, model_output_clean=model_output_clean, eps=eps,
            )
        # the module's weights serve; training differentiates an explicit
        # parameter dict (`_loss_impl`), so no call records graphs on them
        self.core = core.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        # the time embedding's frequencies stay float32 whatever the dtype;
        # so do the modality projections and pos-emb MLPs, which flax builds
        # without a dtype and so computes in float32 in a bf16 model
        self.core.transformer.fourier_weights = self.core.transformer.fourier_weights.float()
        for module in (self.core.latent_to_model, self.core.model_to_latent,
                       self.core.pos_emb_mlps):
            module.float()
        # so do the hyper-connections' weights (the JAX module has no dtype)
        for block in self.core.transformer.blocks:
            block.hc_attn.float()
            block.hc_ff.float()
        self._param_dtypes = {k: p.dtype for k, p in self.core.named_parameters()}

    def _norm_aux(self, x) -> list:
        """Encoders or decoders, one entry per modality (the JAX
        `norm_aux`): None; a module (for every modality); a (module,
        state_dict) pair; or a per-modality list of modules, pairs and
        None. With two modalities, (module, None) reads as the list
        [module, None] (with a warning); spell a pair [(module, None)]."""
        T = self.num_modalities
        if x is None:
            return [None] * T
        tup = x if isinstance(x, (tuple, list)) else (x,)
        if (len(tup) == 2 and isinstance(tup[0], nn.Module) and not isinstance(tup[1], nn.Module)
                and (tup[1] is not None or T != 2)):
            tup = (tup,)  # one (module, state_dict) pair
        elif len(tup) == 2 and isinstance(tup[0], nn.Module) and tup[1] is None:
            warnings.warn(
                "(module, None) with 2 modality types is read as a per-modality list "
                "[encoder, no-encoder]; spell a (module, state_dict) pair as [(module, None)]",
                stacklevel=3)
        tup = list(tup)
        if len(tup) not in (1, T):
            raise ValueError(f"{len(tup)} encoders/decoders for {T} modalities")
        if len(tup) == 1 and T > 1:
            tup = tup * T
        out = []
        for item in tup:
            if item is None:
                out.append(None)
            elif isinstance(item, nn.Module):
                out.append(_frozen(item, None, self.device))
            else:
                out.append(_frozen(item[0], item[1], self.device))
        return out

    # ------------------------------------------------------------------
    # accessors (JAX `transfusion.py:632-656`)
    # ------------------------------------------------------------------

    def get_modality_info(self, modality_type: Optional[int] = None) -> dict:
        """Modality `modality_type`'s (default 0) configuration, its token
        ids and its frozen encoder / decoder (None where it has none)."""
        i = default(modality_type, 0)
        mc = self.modalities[i]
        return dict(
            modality_type=i, dim_latent=mc.dim_latent,
            channel_first_latent=mc.channel_first_latent, add_pos_emb=mc.add_pos_emb,
            num_dim=mc.num_dim, default_shape=mc.default_shape, to_shape_fn=mc.to_shape_fn,
            som_id=self.som_ids[i], eom_id=self.eom_ids[i],
            encoder=self.encoders[i], decoder=self.decoders[i],
        )

    def get_all_modality_info(self) -> list:
        return [self.get_modality_info(i) for i in range(self.num_modalities)]

    def get_modality_shape(self, modality, modality_type: Optional[int] = None) -> tuple:
        """The spatial shape of one modality item in the user's layout."""
        mc = self.modalities[default(modality_type, 0)]
        shape = tuple(np.shape(modality))
        if mc.channel_first_latent and len(shape) > 1:
            shape = shape[1:] + shape[:1]
        return shape[:-1]

    def create_dataloader(self, dataset, **kwargs):
        """A list-collating `DataLoader` over `dataset` (`data/dataloader.py`)."""
        from transfusion_tpu_torch.data.dataloader import create_dataloader

        return create_dataloader(dataset, **kwargs)

    # ------------------------------------------------------------------
    # weights and packing
    # ------------------------------------------------------------------

    def load_flax(self, params):
        """Load the JAX package's params (a nested dict of numpy arrays)."""
        from transfusion_tpu_torch.weights import from_flax

        self.core.load_state_dict(from_flax(params, self.core))
        self.core.transformer.fourier_weights = self.core.transformer.fourier_weights.float()
        return self

    def seq_shape_for(self, modality_type: int, spatial: tuple) -> tuple:
        """The sequence shape (after latent_to_model) of a latent's spatial
        shape: the pre module's output shape on a zero latent, computed
        once per (type, shape) (reading a shape needs no host sync)."""
        key = (modality_type, tuple(int(s) for s in spatial))
        if key not in self._seq_shape_cache:
            shape = key[1]
            if self.pre_post[modality_type] is not None:
                d = self.modalities[modality_type].dim_latent
                with torch.no_grad():
                    out = self.core.latent_to_model[modality_type](
                        torch.zeros((1, *shape, d), device=self.device))
                shape = tuple(out.shape[1:-1])
            self._seq_shape_cache[key] = shape
        return self._seq_shape_cache[key]

    def seq_len_for(self, modality_type: int, spatial: tuple) -> int:
        """The sequence rows of one latent of `spatial` shape."""
        return int(math.prod(self.seq_shape_for(modality_type, spatial)))

    @property
    def pack_spec(self) -> PackSpec:
        mods = tuple(
            ModalityPackSpec(
                dim_latent=mc.dim_latent, channel_first=mc.channel_first_latent,
                num_dim=mc.num_dim, som_id=self.som_ids[i], eom_id=self.eom_ids[i],
                seq_shape_fn=functools.partial(self.seq_shape_for, i),
            )
            for i, mc in enumerate(self.modalities)
        )
        return PackSpec(
            num_text_tokens=self.num_text_tokens, sos_id=self.sos_id, eos_id=self.eos_id,
            null_text_id=self.null_text_id, meta_id=self.meta_id,
            char_offset=self.char_offset, modalities=mods,
        )

    def pack(self, samples, **kw):
        kw.setdefault("pad_multiple", self.pad_multiple)
        return pack_samples(samples, self.pack_spec, **kw)

    # ------------------------------------------------------------------
    # encoders / decoders (frozen, JAX `transfusion.py:726-766`)
    # ------------------------------------------------------------------

    def _aux_apply(self, slot: list, modality_type: int, batch):
        """Run modality_type's encoder or decoder (from `slot`) on a batch
        (float32, on the model's device) without a gradient; the batch as
        it is when that modality has none."""
        module = slot[modality_type]
        if module is None:
            return batch
        x = self._floats(batch)
        weight = next(module.parameters(), None)
        with torch.no_grad():
            return module(x if weight is None else x.to(weight.dtype)).to(torch.float32)

    def _aux_samples(self, slot: list, samples):
        for i, module in enumerate(slot):
            if module is not None:
                samples = apply_modality_fn(
                    lambda b, i=i: self._aux_apply(slot, i, b).cpu().numpy(), samples,
                    modality_type=i)
        return samples

    def encode_modalities(self, samples):
        """Encode every modality of one sample or a list of samples (same
        shapes batched into one call); types without an encoder pass."""
        return self._aux_samples(self.encoders, samples)

    def decode_modalities(self, samples):
        """Decode every modality of one sample or a list of samples."""
        return self._aux_samples(self.decoders, samples)

    def parameters_without_encoder_decoder(self) -> dict:
        """The trainable parameters: the core's (encoders and decoders live
        outside it; a pre/post projection is part of it)."""
        return dict(self.core.named_parameters())

    def create_ema(self, params: Optional[dict] = None, beta: float = 0.99, **kwargs):
        """An `EMA` of `params` (default: the model's weights); its samplers
        run the model on the EMA weights."""
        from transfusion_tpu_torch.training.ema import EMA

        return EMA(self, default(params, self.parameters_without_encoder_decoder()),
                   beta=beta, **kwargs)

    def muon_parameters(self, params: Optional[dict] = None) -> list:
        """The names of the parameters that `muon_param_mask` hands to Muon
        (the JAX mask's selection, `to_value_residual_mix` included)."""
        from transfusion_tpu_torch.training.optim import muon_param_mask

        mask = muon_param_mask(default(params, self.parameters_without_encoder_decoder()))
        return [k for k, m in mask.items() if m]

    def _ids(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=self.device)

    def _cache(self, batch, cap, quantize, track_mask):
        cfg = self.transformer_cfg
        return make_kv_cache(
            cfg["depth"], batch, cfg.get("heads", 8), cap, cfg.get("dim_head", 64),
            dtype=self.dtype, track_mask=track_mask,
            quantize="int8" if quantize else None, device=self.device,
        )

    def _plan(self, cap, batch, kv_quantize):
        cfg = self.transformer_cfg
        plan = plan_serving(cap, batch, laser=bool(cfg.get("attn_laser", False)),
                            flash=cfg.get("attn_impl", "dense") == "flash",
                            kv_quantize=kv_quantize)
        logger.debug("serving plan: %s", "; ".join(plan.reasons))
        return plan

    # ------------------------------------------------------------------
    # joint loss
    # ------------------------------------------------------------------

    def make_draws(self, packed, generator=None, times=None,
                   velocity: bool = False) -> LossDraws:
        """Draws for one loss evaluation of the (torch) packed batch, from
        `generator` (torch's default generator when None): the two uniforms
        of `default_modality_times` (unless times Float[b, m] is given), the
        CFG-drop uniforms and one standard normal per latent group; with
        `velocity`, a second normal per group for the EMA forward."""
        b, m = packed.spans.shape[:2]
        dev = packed.text.device
        u = torch.rand((3, b), generator=generator, device=dev)
        if times is None:
            num_mods = (packed.spans[..., 2] > 0).sum(-1)
            times = default_modality_times(u[0], u[1], num_mods, m)

        def normals():
            return tuple(torch.randn(tuple(g.latents.shape), generator=generator, device=dev)
                         for g in packed.groups)

        noises = normals()
        return LossDraws(times=torch.as_tensor(times, dtype=torch.float32, device=dev),
                         cfg_uniform=u[2], noises=noises,
                         ema_noises=normals() if velocity else ())

    def _compute_params(self, params: dict) -> dict:
        """A parameter dict (e.g. float32 masters) cast to the dtypes of the
        module's own weights: the compute dtype, float32 for the modality
        projections and pos-emb MLPs."""
        return {k: p.to(self._param_dtypes[k]) for k, p in params.items()}

    def _joint_core(self, params, packed, times, noises, return_logits: bool = True,
                    pipeline=None):
        """Noise each latent group (x_t = t x + (1 - t) noise, flow target
        x - noise) and run the core's joint forward, on `params` when given
        (else the module's own weights); `pipeline` (where, microbatches)
        runs its transformer on the GPipe schedule. Returns (logits | None,
        embed, pred_flows, flows, noised latents per group)."""
        noised_groups, flows = [], []
        for g, noise in zip(packed.groups, noises):
            t_inst = times[g.batch_idx, g.span_rows]
            noised, flow = noise_data(g.latents, noise, t_inst)
            noised_groups.append(g.replace(latents=noised))
            flows.append(flow)
        packed_n = packed.replace(groups=tuple(noised_groups))
        kw = {"return_logits": return_logits, "pipeline": pipeline}
        if params is None:
            out = self.core(packed_n, times, **kw)
        else:  # cast inside the autograd graph: the grads arrive in params' dtype
            out = torch.func.functional_call(self.core, self._compute_params(params),
                                             (packed_n, times), kw)
        logits, embed, pred_flows, _, _ = out
        return logits, embed, pred_flows, flows, [g.latents for g in noised_groups]

    def _chunked_ce(self, params, embed, labels, valid):
        """The JAX `_chunked_ce` (`transfusion.py:828-856`): the CE sum over
        chunks of `ce_chunk_size` positions (the tail padded with invalid
        positions), each chunk checkpointed, so that neither the [b, n,
        vocab] logits nor their gradient is ever held whole."""
        weight = (self.core.to_text_logits.weight if params is None
                  else params["to_text_logits.weight"].to(self.dtype))
        C = self.ce_chunk_size
        pad = (-embed.shape[1]) % C
        if pad:
            embed = F.pad(embed, (0, 0, 0, pad))
            labels, valid = F.pad(labels, (0, pad)), F.pad(valid, (0, pad))
        ce_sum = torch.zeros((), device=embed.device)
        for i in range(0, embed.shape[1], C):
            ce_sum = ce_sum + checkpoint(_ce_chunk_sum, self.core, embed[:, i:i + C], weight,
                                         labels[:, i:i + C], valid[:, i:i + C],
                                         use_reentrant=False)
        return ce_sum

    def _cfg_dropped_text(self, packed, draws: LossDraws, prob_uncond: float, train: bool):
        """CFG dropout of whole samples' text to the null id (`cfg_mask`
        positions of the samples whose uniform is below prob_uncond)."""
        if not (train and prob_uncond > 0):
            return packed.text
        drop = draws.cfg_uniform < prob_uncond
        return torch.where(drop[:, None] & packed.cfg_mask, self.null_text_id, packed.text)

    def _valid_labels(self, labels, spans):
        """Text positions that carry a CE term: not ignore_index, not the
        null id, not inside a modality."""
        return ((labels != self.ignore_index) & (labels != self.null_text_id)
                & ~spans_to_is_any_modality(labels.shape[1], spans))

    def loss_denominators(self, packed, draws: LossDraws, train: bool = True,
                          prob_uncond: Optional[float] = None) -> dict:
        """The joint loss's normalization constants for one (micro)batch of
        torch tensors (the JAX `loss_denominators`, `transfusion.py:1067`):
        kept text labels after the CFG dropout of `draws`, total tokens,
        tokens per modality type, latent elements and instances per type,
        as float32 tensors. None depends on the parameters, so gradient
        accumulation sums them over the microbatches
        (`sum_loss_denominators`) and hands the totals to every
        microbatch's `_loss_impl`."""
        T = self.num_modalities
        prob_uncond = self.prob_uncond if prob_uncond is None else prob_uncond
        labels = self._cfg_dropped_text(packed, draws, prob_uncond, train)[:, 1:]
        dev = labels.device
        mod_mask = spans_to_modality_mask(labels.shape[1], packed.spans, T)
        elem_counts, inst_counts = [0] * T, [0] * T
        for g in packed.groups:
            elem_counts[g.modality_type] += int(math.prod(g.latents.shape))
            inst_counts[g.modality_type] += int(g.latents.shape[0])
        return {
            "kept": self._valid_labels(labels, packed.spans).sum().to(torch.float32),
            "total_tokens": torch.tensor(float(packed.total_tokens), device=dev),
            "type_token_counts": mod_mask.any(dim=2).sum(dim=(0, 2)).to(torch.float32),
            "elem_counts": torch.tensor(elem_counts, dtype=torch.float32, device=dev),
            "inst_counts": torch.tensor(inst_counts, dtype=torch.float32, device=dev),
        }

    @staticmethod
    def sum_loss_denominators(denoms) -> dict:
        """The global denominators of a batch split into microbatches: the
        sum of each microbatch's `loss_denominators`."""
        return {k: sum(d[k] for d in denoms) for k in denoms[0]}

    def _loss_impl(self, params, packed, draws: LossDraws, prob_uncond: float,
                   train: bool = True, loss_scales: Optional[dict] = None,
                   ema_params: Optional[dict] = None, velocity_delta: float = 1e-3,
                   pipeline=None):
        """The joint loss of the JAX `_loss_impl` (`transfusion.py:858-1065`):
        CFG dropout of whole samples' text, the next-token shift, text CE
        over valid labels (not ignore_index, not null, not inside a
        modality; chunked with `ce_chunk_size`), per-type flow MSE,
        weighted by the text and per-type token
        fractions; with `ema_params` (a parameter dict, e.g. the Trainer's
        EMA masters) the velocity-consistency MSE against an EMA forward,
        and with `reconstruction_loss_weight` the reconstruction MSE. packed
        holds torch tensors. Every mean divides by `loss_scales` (the
        summed `loss_denominators` of all microbatches of a step, so that
        the microbatches' losses and gradients sum to the whole batch's),
        or by this batch's own. `pipeline`: (where, microbatches[,
        schedule]), where is a mesh with a 'pipe' axis or
        `parallel.pipeline.LocalStages`: 'gpipe' (the default) runs the
        transformer on the GPipe schedule, '1f1b' the whole loss through
        `models/pipeline_loss.py` (JAX's dispatch, `transfusion.py:905-940`);
        the batch is the whole batch on every rank. Returns (total,
        LossBreakdown)."""
        T = self.num_modalities
        dropout = self.transformer_cfg.get("dropout", 0.0)
        if train and dropout > 0:
            raise ValueError(
                f"loss(train=True) with dropout={dropout}: the JAX package applies the core "
                "with deterministic=False and no 'dropout' rng there, and flax refuses it "
                "(InvalidRngError: Dropout_0 needs PRNG for \"dropout\"); the port refuses "
                "the same call. Use train=False (dropout is then a no-op), or apply the "
                "core's joint / text_forward / modality_forward with explicit dropout masks")
        if pipeline is not None:
            if loss_scales is not None:
                raise ValueError("loss_scales (gradient accumulation) cannot combine with "
                                 "pipeline parallelism — pick one batch-splitting axis")
            where, microbatches, *schedule = pipeline
            schedule = schedule[0] if schedule else "gpipe"
            if schedule not in ("gpipe", "1f1b"):
                raise ValueError(f"unknown pipeline schedule {schedule}")
            pipeline = (where, microbatches)
        scales = loss_scales
        if scales is None:
            scales = self.loss_denominators(packed, draws, train, prob_uncond)
        has_velocity = ema_params is not None
        if has_velocity and len(draws.ema_noises) != len(packed.groups):
            raise ValueError("the velocity-consistency loss needs draws.ema_noises, one per "
                             "latent group (make_draws(..., velocity=True))")
        # the trained forward runs at t (1 - delta), the EMA target at t + delta
        times = draws.times * (1.0 - velocity_delta) if has_velocity else draws.times
        text = self._cfg_dropped_text(packed, draws, prob_uncond, train)
        text_in, labels = text[:, :-1], text[:, 1:]
        if pipeline is not None and schedule == "1f1b":
            from transfusion_tpu_torch.models.pipeline_loss import joint_loss_1f1b

            return joint_loss_1f1b(self, params, packed, packed.replace(text=text_in), labels,
                                   times, draws.times, draws, scales, ema_params,
                                   velocity_delta, *pipeline)
        chunked = self.ce_chunk_size is not None
        logits, embed, pred_flows, flows, noised = self._joint_core(
            params, packed.replace(text=text_in), times, draws.noises,
            return_logits=not chunked, pipeline=pipeline)
        if has_velocity:
            # the EMA target sees the text before the CFG dropout (the JAX
            # `_loss_impl`, `transfusion.py:978-994`); no graph is kept
            with torch.no_grad():
                ema_flows = self._joint_core(
                    ema_params, packed.replace(text=packed.text[:, :-1]),
                    draws.times + velocity_delta, draws.ema_noises, return_logits=False,
                    pipeline=pipeline)[2]

        valid = self._valid_labels(labels, packed.spans)
        safe_labels = torch.where(valid, labels, 0)
        if chunked:
            ce_sum = self._chunked_ce(params, embed, safe_labels, valid)
        else:
            logp = torch.log_softmax(logits.float(), dim=-1)
            label_logp = logp.gather(-1, safe_labels[..., None])[..., 0]
            ce_sum = -(label_logp * valid).sum()
        text_loss = ce_sum / scales["kept"].clamp_min(1.0)
        text_frac = scales["kept"] / scales["total_tokens"]
        fracs = scales["type_token_counts"] / scales["total_tokens"]

        flow_losses, velocity_losses, recon_losses = [], [], []
        zero = torch.zeros((), device=embed.device)
        for t in range(T):
            sse, v_sse, r_parts = zero, zero, []
            for gi, g in enumerate(packed.groups):
                if g.modality_type != t:
                    continue
                sse = sse + ((pred_flows[gi] - flows[gi]).float() ** 2).sum()
                if has_velocity:
                    v_sse = v_sse + ((pred_flows[gi] - ema_flows[gi]).float() ** 2).sum()
                if self.has_recon_loss:
                    # the reconstructed latent against the NOISED one, as
                    # the JAX package writes it (`transfusion.py:1010-1019`)
                    t_inst = times[g.batch_idx, g.span_rows]
                    t_b = t_inst.reshape(-1, *(1,) * (pred_flows[gi].ndim - 1))
                    recon = draws.noises[gi] + pred_flows[gi] * (1.0 - t_b)
                    r_parts.append(((recon - noised[gi]) ** 2).flatten(1).mean(1))
            denom = scales["elem_counts"][t].clamp_min(1.0)
            flow_losses.append(sse / denom)
            if has_velocity:
                velocity_losses.append(v_sse / denom)
            if self.has_recon_loss:
                if not r_parts:
                    recon_losses.append(zero)
                elif loss_scales is not None:
                    recon_losses.append(torch.cat(r_parts).sum()
                                        / loss_scales["inst_counts"][t].clamp_min(1.0))
                else:
                    recon_losses.append(torch.cat(r_parts).mean())
        flow_total = sum(fl * fracs[t] for t, fl in enumerate(flow_losses))

        total = (text_loss * text_frac * self.text_loss_weight
                 + flow_total * self.flow_loss_weight)
        if has_velocity:
            total = total + sum(vl * fracs[t] for t, vl in enumerate(velocity_losses)) \
                * self.velocity_consistency_loss_weight
        if self.has_recon_loss:
            total = total + sum(rl * fracs[t] for t, rl in enumerate(recon_losses)) \
                * self.reconstruction_loss_weight
        return total, LossBreakdown(total=total, text=text_loss, flow=flow_losses,
                                    velocity=velocity_losses if has_velocity else None,
                                    recon=recon_losses if self.has_recon_loss else None)

    def loss(self, batch=None, draws: Optional[LossDraws] = None, *, params=None,
             generator=None, times=None, num_modalities_to_times_fn=None,
             velocity_consistency_ema_params=None,
             velocity_consistency_delta_time: float = 1e-3,
             prob_uncond: Optional[float] = None, return_breakdown: bool = False,
             train: bool = True, packed=None, pipeline=None):
        """Joint multimodal training loss of a ragged batch (a list of
        samples, encoded and packed here with shift_friendly=True) or of
        `packed` (numpy or torch). The draws come from `draws`, else from
        `generator`; `times` Float[b, m] or `num_modalities_to_times_fn`
        override the drawn times. `params`: an explicit parameter dict to
        differentiate (default: the module's weights).
        `velocity_consistency_ema_params`: the EMA parameter dict of the
        velocity-consistency term (its forward runs at t + delta).
        `pipeline`: (mesh, microbatches) | (mesh, microbatches, 'gpipe' |
        '1f1b') runs the loss pipeline-parallel over the mesh's 'pipe' axis
        (`_loss_impl`; `parallel.pipeline.LocalStages(P)` in place of the
        mesh runs the P stages in this process). It needs unet_skips=False,
        num_residual_streams=1 and dropout=0; `Trainer(pipeline_microbatches=,
        pipeline_schedule=)` is the managed entry point."""
        velocity = velocity_consistency_ema_params is not None
        if packed is None:
            batch = self.encode_modalities(batch)
            packed = self.pack(batch, wrap_sos_eos=True, add_meta=True, shift_friendly=True)
        if not isinstance(packed.text, torch.Tensor):
            packed = packed.to_torch(self.device)
        if num_modalities_to_times_fn is not None and times is None:
            num_mods = (packed.spans[..., 2] > 0).sum(-1).cpu().numpy()
            times = np.asarray(num_modalities_to_times_fn(num_mods), np.float32)
            pad = packed.spans.shape[1] - times.shape[1]
            times = np.pad(times, ((0, 0), (0, max(pad, 0))))
        if draws is None:
            draws = self.make_draws(packed, generator, times, velocity=velocity)
        elif times is not None:
            draws = dataclasses.replace(
                draws, times=torch.as_tensor(times, dtype=torch.float32, device=self.device))
        total, breakdown = self._loss_impl(
            params, packed, draws, float(default(prob_uncond, self.prob_uncond)), train,
            ema_params=velocity_consistency_ema_params,
            velocity_delta=float(velocity_consistency_delta_time), pipeline=pipeline)
        return (total, breakdown) if return_breakdown else total

    # ------------------------------------------------------------------
    # text-only and modality-only forwards (JAX `forward_text`,
    # `forward_modality`, `forward`, `transfusion.py:1214-1404`)
    # ------------------------------------------------------------------

    def _text_loss_impl(self, text, params=None):
        """Next-token CE of text Int[b, n] over the text vocabulary, mean
        over the labels that are not ignore_index; on `params` (a parameter
        dict, cast by `_compute_params`) when given, else on the module's
        weights."""
        inp, labels = text[:, :-1], text[:, 1:]
        if params is None:
            logits = self.core.text_forward(inp)[0]
        else:
            logits = torch.func.functional_call(self.core, self._compute_params(params), (inp,),
                                                {"method": "text_forward"})[0]
        logits = logits.float()
        text_only = torch.arange(self.vocab_size, device=logits.device) < self.num_text_tokens
        logits = torch.where(text_only, logits, max_neg_value(torch.float32))
        logp = torch.log_softmax(logits, dim=-1)
        valid = labels != self.ignore_index
        label_logp = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
        return -(label_logp * valid).sum() / valid.sum().clamp_min(1)

    def forward_text(self, text, return_loss: bool = True):
        """The causal LM on text Int[b, n]: its loss, or (return_loss=False)
        the logits [b, n, vocab] of the whole vocabulary."""
        text = self._ids(text)
        if return_loss:
            return self._text_loss_impl(text)
        return self.core.text_forward(text)[0]

    def _modality_flow(self, noised, times, modality_type: int, params=None):
        """The predicted flow in latent space from the current state, on
        `params` (a parameter dict, cast by `_compute_params`) when given,
        else on the module's weights."""
        if params is None:
            out = self.core.modality_forward(noised, times, modality_type)
        else:
            out = torch.func.functional_call(self.core, self._compute_params(params),
                                             (noised, times, modality_type),
                                             {"method": "modality_forward"})
        if self.core.model_output_clean:
            out = model_output_to_flow(out, noised, times, self.core.eps)
        return out

    def _modality_loss_impl(self, latents, orig, times, noise, modality_type: int,
                            params=None, ema_params=None, velocity_delta: float = 1e-5):
        """The JAX `_modality_loss_impl` (`transfusion.py:1254-1306`) on
        clean channel-last latents [b, *shape, d], noised to x_t = t x +
        (1 - t) noise at times Float[b] (times (1 - delta) with
        `ema_params`). Terms: the flow MSE; with `ema_params` the velocity
        MSE of the true flow against the EMA model's flow from the CLEAN
        latents at t + delta (no gradient reaches the trained parameters,
        as in JAX); with `reconstruction_loss_weight` the MSE of
        noise + flow (1 - t), decoded in the user layout when the modality
        has a decoder, against `orig`, the input before encoding. Returns
        (total, (flow, velocity, reconstruction))."""
        orig_times = times
        if ema_params is not None:
            times = times * (1.0 - velocity_delta)
        noised, flow = noise_data(latents, noise, times)
        pred_flow = self._modality_flow(noised, times, modality_type, params)
        flow_loss = ((pred_flow - flow) ** 2).mean()
        velocity_loss = recon_loss = torch.zeros((), device=flow_loss.device)
        if ema_params is not None:
            with torch.no_grad():
                ema_flow = self._modality_flow(latents, orig_times + velocity_delta,
                                               modality_type, ema_params)
            velocity_loss = ((flow - ema_flow) ** 2).mean()
        if self.has_recon_loss:
            t_b = times.reshape(-1, *(1,) * (latents.ndim - 1))
            recon = noise + pred_flow * (1.0 - t_b)
            if self.decoders[modality_type] is not None:
                if self.modalities[modality_type].channel_first_latent:
                    recon = recon.movedim(-1, 1)
                recon = self._aux_apply(self.decoders, modality_type, recon)
            recon_loss = ((recon - orig) ** 2).mean()
        total = (flow_loss + velocity_loss * self.velocity_consistency_loss_weight
                 + recon_loss * self.reconstruction_loss_weight)
        return total, (flow_loss, velocity_loss, recon_loss)

    def forward_modality(self, modalities, times=None, noise=None, generator=None,
                         modality_type: Optional[int] = None, encode_modality: bool = True,
                         velocity_consistency_ema_params=None,
                         velocity_consistency_delta_time: float = 1e-5,
                         return_loss: bool = True, return_loss_breakdown: bool = False,
                         params=None):
        """The modality-only path on a batch [b, *shape, ...] in the user
        layout, encoded first when the modality has an encoder (and
        `encode_modality`). return_loss=False: the predicted flow at `times`
        Float[b]. Else the loss on explicit draws: `times` (default
        uniform) and `noise` shaped like the channel-last latents (default
        standard normal), each drawn from `generator` when not given (the
        JAX package derives both from one key, `transfusion.py:1265-1274`).
        `velocity_consistency_ema_params`: the EMA parameter dict of the
        velocity term; `params`: a parameter dict to differentiate
        (default: the module's weights)."""
        if self.num_modalities > 1 and modality_type is None:
            raise ValueError("modality_type is required with more than one modality")
        modality_type = default(modality_type, 0)
        mc = self.modalities[modality_type]
        orig = self._floats(modalities)
        x = orig
        if encode_modality:
            x = self._aux_apply(self.encoders, modality_type, x)
        if mc.channel_first_latent and x.ndim > 2:
            x = x.movedim(1, -1)  # the channel-last internal layout
        b = x.shape[0]
        if not return_loss:
            if times is None:
                raise ValueError("forward_modality(return_loss=False) needs times")
            out = self._modality_flow(x, self._floats(times), modality_type, params)
            return out.movedim(-1, 1) if mc.channel_first_latent and out.ndim > 2 else out
        times = (torch.rand((b,), generator=generator, device=self.device) if times is None
                 else self._floats(times))
        noise = (torch.randn(x.shape, generator=generator, device=self.device) if noise is None
                 else self._floats(noise))
        total, parts = self._modality_loss_impl(
            x, orig, times, noise, modality_type, params=params,
            ema_params=velocity_consistency_ema_params,
            velocity_delta=float(velocity_consistency_delta_time))
        return (total, parts) if return_loss_breakdown else total

    def forward(self, batch, generator=None, **kwargs):
        """Dispatch as the JAX `forward`: integer tokens go to
        `forward_text`, floating latents to `forward_modality`, a list of
        samples to the joint `loss`."""
        if hasattr(batch, "dtype"):
            if torch.is_tensor(batch):
                is_int = not (batch.is_floating_point() or batch.is_complex())
            else:
                is_int = np.issubdtype(np.asarray(batch).dtype, np.integer)
            if is_int:
                return self.forward_text(batch, return_loss=kwargs.pop("return_loss", True))
            return self.forward_modality(batch, generator=generator, **kwargs)
        return self.loss(batch, generator=generator, **kwargs)

    def __call__(self, batch, generator=None, **kwargs):
        return self.forward(batch, generator=generator, **kwargs)

    def _floats(self, x):
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # text-only generation
    # ------------------------------------------------------------------

    def _sample_text_tok(self, logits_last, temperature, min_p, generator):
        """Next text token from [b, vocab] logits: mask to text ids BEFORE
        min-p (min-p over the full vocab can -inf every text id)."""
        text_only = torch.arange(self.vocab_size, device=logits_last.device) < self.num_text_tokens
        masked = torch.where(text_only[None], logits_last.float(), float("-inf"))
        return gumbel_sample(min_p_filter(masked, min_p), temperature, generator)

    def _gen_text_impl(self, prompt, generator, *, steps, temperature, min_p, quantize):
        b, n0 = prompt.shape
        cap = round_up_to_multiple(n0 + steps, 128)
        cache = self._cache(b, cap, quantize, track_mask=False)
        logits, cache = self.core.text_forward(prompt, cache, prefill=True)
        logits_last = logits[:, -1]
        toks = []
        for _ in range(steps):
            tok = self._sample_text_tok(logits_last, temperature, min_p, generator)
            pos = cache["idx"].reshape(1).long()
            logits, cache = self.core.text_forward(tok[:, None], cache, pos)
            logits_last = logits[:, -1]
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def _gen_text_ragged_impl(self, prompt, lengths, generator, *, steps, temperature,
                              min_p, quantize):
        """Ragged batched decode: rows padded to a rectangle, row i's real
        history is lengths[i] tokens; decode continues from each row's own
        history end (per-row cache write offsets)."""
        b, n0 = prompt.shape
        cap = round_up_to_multiple(n0 + steps, 128)
        cache = self._cache(b, cap, quantize, track_mask=True)
        cache["mask"] = torch.arange(cap, device=self.device)[None, :] < lengths[:, None]
        logits, cache = self.core.text_forward(prompt, cache, prefill=True)
        last = logits[torch.arange(b, device=self.device), lengths - 1]
        cache = {**cache, "idx": lengths.to(torch.int32)}
        toks = []
        ones = torch.ones((b, 1), dtype=torch.bool, device=self.device)
        for _ in range(steps):
            tok = self._sample_text_tok(last, temperature, min_p, generator)
            pos = cache["idx"][:, None].long()
            cache = cache_mark_valid(cache, ones)
            logits, cache = self.core.text_forward(tok[:, None], cache, pos)
            last = logits[:, -1]
            toks.append(tok)
        return torch.stack(toks, dim=1)

    @torch.no_grad()
    def generate_text_only(self, prompt, seq_len: int, generator=None,
                           temperature: float = 1.5, min_p: float = 0.1,
                           kv_quantize: Optional[bool] = None, prompt_lengths=None):
        """Decode seq_len - prompt.shape[-1] tokens after prompt Int[b, n0].
        prompt_lengths Int[b]: ragged serving, row i's real history is
        prompt[i, :prompt_lengths[i]]. kv_quantize=True: int8 KV cache.
        Returns Int64[b, steps] on the model's device."""
        prompt = self._ids(prompt)
        if prompt.ndim == 1:
            prompt = prompt[None]
        b, n0 = prompt.shape
        steps = max(0, seq_len - n0)
        if steps == 0:
            return prompt[..., 0:0]
        plan = self._plan(round_up_to_multiple(seq_len, 128), b, kv_quantize)
        kw = dict(steps=steps, temperature=float(temperature), min_p=float(min_p),
                  quantize=plan.kv_quantize)
        if prompt_lengths is not None:
            return self._gen_text_ragged_impl(prompt, self._ids(prompt_lengths), generator, **kw)
        return self._gen_text_impl(prompt, generator, **kw)

    def generate_text_batch(self, prompts, max_new_tokens: int, **kwargs):
        """Serving convenience: batch ragged requests (a list of 1-D int
        arrays), decode max_new_tokens each. The rectangle width is bucketed
        to the next power-of-two multiple of 128. Returns Int64[b, max_new_tokens]."""
        lengths = [int(np.asarray(p).size) for p in prompts]
        if min(lengths) < 1:
            raise ValueError(
                "generate_text_batch: every prompt needs >= 1 token (seed an "
                f"empty row with a BOS/sos token); got lengths {lengths}"
            )
        chunks = -(-max(lengths) // 128)
        width = 128 * (1 << (chunks - 1).bit_length())
        arr = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            arr[i, : lengths[i]] = np.asarray(p).reshape(-1)
        return self.generate_text_only(
            arr, seq_len=width + max_new_tokens,
            prompt_lengths=np.asarray(lengths, np.int64), **kwargs,
        )

    # ------------------------------------------------------------------
    # modality-only generation (JAX `generate_modality_only`,
    # `transfusion.py:1619-1665`)
    # ------------------------------------------------------------------

    def _gen_modality_impl(self, noise, *, modality_type, steps):
        bs = noise.shape[0]

        def flow(t, y):
            times = torch.as_tensor(t, dtype=torch.float32).to(y.device).reshape(1).expand(bs)
            return self._modality_flow(y, times, modality_type)

        grid = torch.linspace(0.0, 1.0, steps, dtype=torch.float32)
        return odeint(flow, noise, grid, method=self.odeint_method)

    @torch.no_grad()
    def generate_modality_only(self, batch_size: int = 1, modality_type: Optional[int] = None,
                               fixed_modality_shape: Optional[tuple] = None,
                               modality_steps: int = 16, generator=None, noise=None,
                               return_unprocessed_modalities: bool = False):
        """Sample batch_size latents of one modality by the flow ODE alone,
        from `noise` [b, *shape, d] channel-last (b replaces batch_size) or
        from a standard normal drawn with `generator`. Returns float32
        latents in the user layout on the model's device, decoded when the
        modality has a decoder (unless return_unprocessed_modalities)."""
        if self.num_modalities > 1 and modality_type is None:
            raise ValueError("modality_type is required with more than one modality")
        modality_type = default(modality_type, 0)
        mc = self.modalities[modality_type]
        if noise is None:
            shape = default(fixed_modality_shape, mc.default_shape)
            if shape is None:
                raise ValueError("set modality_default_shape or pass fixed_modality_shape")
            noise = torch.randn((batch_size, *shape, mc.dim_latent), generator=generator,
                                device=self.device)
        sampled = self._gen_modality_impl(self._floats(noise), modality_type=modality_type,
                                          steps=int(modality_steps))
        if mc.channel_first_latent and sampled.ndim > 2:
            sampled = sampled.movedim(-1, 1)
        if return_unprocessed_modalities:
            return sampled
        return self._aux_apply(self.decoders, modality_type, sampled)

    # ------------------------------------------------------------------
    # multimodal sampling
    # ------------------------------------------------------------------

    def _parse_modality_shape(self, text_seq, modality_type: int):
        """Parse the shape meta string preceding the last [som]."""
        mc = self.modalities[modality_type]
        default_shape = mc.default_shape
        meta = tokens_since_rightmost_id(text_seq, self.meta_id)
        shape = None
        if meta.size > 0:
            meta_str = decode_chars(meta[:-1], offset=self.char_offset)
            parts = meta_str.split(",")
            gate_ok = mc.to_shape_fn is not default_to_modality_shape_fn or (
                bool(meta_str) and all(p.isdigit() and int(p) > 0 for p in parts)
            )
            if gate_ok and meta_str:
                try:
                    shape = tuple(mc.to_shape_fn(meta_str))
                except Exception:  # a custom codec's failure means fallback
                    shape = None
            if shape is None:
                if default_shape is None:
                    raise ValueError(
                        "invalid modality meta information — set "
                        "modality_default_shape for a fallback"
                    )
                shape = default_shape
        shape = default(shape, default_shape)
        if self.fallback_to_default_shape_if_invalid:
            if mc.num_dim is not None and shape is not None and len(shape) != mc.num_dim:
                logger.warning("invalid modality shape %s for modality %s; falling back "
                               "to default %s", shape, modality_type, default_shape)
                shape = default_shape
        if shape is None:
            raise ValueError(f"no valid shape for modality {modality_type}; set "
                             "modality_default_shape")
        if mc.num_dim is not None and mc.num_dim != len(shape):
            raise ValueError(f"modality {modality_type} expects {mc.num_dim} dims, got {shape}")
        return shape

    def _prompt_to_items(self, prompt) -> list:
        """Normalize a sample() prompt into [sos] + text arrays /
        (type, latents) tuples, contiguous text concatenated."""
        items: list = []
        if prompt is not None:
            p = prompt
            if hasattr(p, "dtype") and not isinstance(p, tuple):
                arr = np.asarray(p)
                if np.issubdtype(arr.dtype, np.floating):
                    p = (0, arr)
                else:
                    p = [arr.reshape(-1).astype(np.int32)]
            if isinstance(p, tuple):
                mtype, modality = p
                mc = self.modalities[mtype]
                modality = np.asarray(modality, np.float32)
                if self.encoders[mtype] is not None:
                    modality = self._aux_apply(self.encoders, mtype, modality[None])[0]
                    modality = modality.cpu().numpy()
                cl = to_channel_last(modality, mc.channel_first_latent)
                shape_str = ",".join(map(str, cl.shape[:-1]))
                meta_ids = ([self.meta_id] + [self.char_offset + ord(c) for c in shape_str]
                            + [self.som_ids[mtype]])
                items = [
                    np.asarray(meta_ids, np.int32),
                    (mtype, to_user_layout(cl, mc.channel_first_latent)),
                    np.asarray([self.eom_ids[mtype]], np.int32),
                ]
            else:
                items = list(p)
        sample_items = [np.asarray([self.sos_id], np.int32)] + [
            it if isinstance(it, tuple) else np.asarray(it).reshape(-1).astype(np.int32)
            for it in normalize_sample(items)
        ]
        return concat_contiguous_text(sample_items)

    def _modality_trigger(self, items, fixed_modality_shape=None):
        """(modality type, latent shape) when the last text token of the
        sample items is a [som] (the shape from fixed_modality_shape, else
        from the meta string before it), else None."""
        last = items[-1]
        if isinstance(last, tuple) or len(last) == 0:
            return None
        tok = int(np.asarray(last)[-1])
        if tok not in self.som_ids:
            return None
        mid = self.som_ids.index(tok)
        if fixed_modality_shape is not None:
            return mid, tuple(fixed_modality_shape)
        return mid, tuple(self._parse_modality_shape(last, mid))

    def _segment_noise(self, init_modality_noise, spatial, modality_type, generator=None):
        """The starting noise of one latent [*spatial, d]: the leading rows of
        init_modality_noise [>= L, >= d] when given, else a standard normal
        drawn with `generator`."""
        d = self.modalities[modality_type].dim_latent
        if init_modality_noise is None:
            return torch.randn((*spatial, d), generator=generator, device=self.device)
        flat = np.asarray(init_modality_noise)[: int(math.prod(spatial)), :d]
        return torch.tensor(flat, dtype=torch.float32).reshape(*spatial, d).to(self.device)

    @torch.no_grad()
    def sample(self, prompt=None, generator=None, max_length: int = 2048,
               text_temperature: float = 1.5, text_min_p: float = 0.1,
               cache_kv: bool = False, kv_quantize: Optional[bool] = None,
               fixed_modality_shape: Optional[tuple] = None, init_modality_noise=None,
               modality_steps: int = 16, return_unprocessed_modalities: bool = False,
               cfg_scale: float = 3.0, incremental_cfg_cache: bool = True):
        """Multimodal sampling: text tokens and, after each [som], a latent
        by the flow ODE with CFG, until eos or max_length. Uncached (the
        default) re-forwards the packed sequence for every token and every
        flow evaluation; cache_kv=True prefills one KV cache and then
        decodes per token and runs tail-only ODE steps (kv_quantize and
        incremental_cfg_cache act there only). A model without a text
        vocabulary samples one latent with `generate_modality_only`.
        Returns the sample items, each modality decoded when it has a
        decoder (unless return_unprocessed_modalities). A modality prompt
        is encoded first."""
        if self.num_text_tokens == 0:
            logger.warning("num_text_tokens == 0: forwarding to generate_modality_only")
            return self.generate_modality_only(batch_size=1, generator=generator)
        sample_items = self._prompt_to_items(prompt)
        if not cache_kv:
            sample_items = self._sample_uncached(
                sample_items, generator, max_length, text_temperature, text_min_p,
                fixed_modality_shape, init_modality_noise, modality_steps, cfg_scale)
        else:
            sample_items = self._sample_cached(
                sample_items, generator, max_length, text_temperature,
                text_min_p, fixed_modality_shape, init_modality_noise, modality_steps,
                cfg_scale, kv_quantize=kv_quantize, incremental_cfg=incremental_cfg_cache,
            )
        if return_unprocessed_modalities:
            return sample_items
        return self.decode_modalities(sample_items)

    def sample_batch(self, prompts, **kwargs):
        """Batched multimodal sampling: R `sample(cache_kv=True)` state
        machines over one pooled cache (`models/sample_batch.py`)."""
        return _sample_batch.sample_batch(self, prompts, **kwargs)

    # -- uncached sampling (JAX `sample`, `transfusion.py:1718-1775`,
    #    `:1883-2042`) ------------------------------------------------------

    def _sample_text_step_impl(self, packed, generator, *, temperature, min_p):
        """The next token after row 0 of a (torch) packed batch: past
        modalities are conditioned as clean (time 1); the token is read at
        lengths[0] - 1."""
        b, m = packed.batch, packed.spans.shape[1]
        times = torch.ones((b, m), device=self.device)
        _, embed, _, _, _ = self.core.joint(packed, times, return_logits=False)
        last = self.core.text_logits(embed[0, packed.lengths[0] - 1]).float()
        return gumbel_sample(min_p_filter(last, min_p), temperature, generator)

    def _sample_ode_impl(self, packed, noise, cfg_scale, *, gi, row_cond, row_uncond,
                         span_row, steps, use_cfg):
        """The flow ODE of one modality segment over the uncached joint
        forward of a (torch) packed batch, packed once: each evaluation
        copies y into the segment's cond (and uncond) rows of group gi's
        latents on the device, sets time t on span row `span_row` (every
        other instance clean, time 1) and guides with CFG."""
        b, m = packed.batch, packed.spans.shape[1]
        g = packed.groups[gi]
        seg_rows = torch.tensor([row_cond, row_uncond] if use_cfg else [row_cond],
                                device=self.device)
        at_span = (torch.arange(m, device=self.device) == span_row)[None, :].expand(b, m)

        def flow(t, y):
            lat = g.latents.index_copy(0, seg_rows, y[None].expand(len(seg_rows), *y.shape))
            groups = tuple(og.replace(latents=lat) if i == gi else og
                           for i, og in enumerate(packed.groups))
            times = torch.where(at_span, torch.as_tensor(t, dtype=torch.float32).to(self.device),
                                1.0)
            _, _, pred_flows, _, _ = self.core.joint(packed.replace(groups=groups), times,
                                                     return_logits=False)
            pf = pred_flows[gi]
            if not use_cfg:
                return pf[row_cond]
            return pf[row_uncond] + cfg_scale * (pf[row_cond] - pf[row_uncond])

        grid = torch.linspace(0.0, 1.0, steps, dtype=torch.float32)
        return odeint(flow, noise, grid, method=self.odeint_method)

    def _sample_uncached(self, sample_items, generator, max_length, text_temperature,
                         text_min_p, fixed_modality_shape, init_modality_noise, modality_steps,
                         cfg_scale):
        """The uncached sampling loop (same order of operations as the JAX
        `sample`): every text step re-forwards the bucket-packed sequence;
        every modality segment packs [cond, uncond] once (the uncond row's
        text nulled) and integrates over it."""
        use_cfg = cfg_scale != 1.0
        curr_length = 0
        trigger = self._modality_trigger(sample_items, fixed_modality_shape)
        while curr_length <= max_length:
            if trigger is None:
                packed = _sample_batch._width_bucket_pack(self, [sample_items])
                tok = int(self._sample_text_step_impl(
                    packed.to_torch(self.device), generator,
                    temperature=float(text_temperature), min_p=float(text_min_p)))
                last = sample_items[-1]
                if isinstance(last, tuple):
                    sample_items.append(np.asarray([tok], np.int32))
                else:
                    sample_items[-1] = np.concatenate([last, np.asarray([tok], np.int32)])
                curr_length += 1
                if tok == self.eos_id:
                    break
                trigger = self._modality_trigger(sample_items, fixed_modality_shape)
                continue

            mid, spatial = trigger
            mc = self.modalities[mid]
            noise = self._segment_noise(init_modality_noise, spatial, mid, generator)
            placeholder = to_user_layout(np.zeros((*spatial, mc.dim_latent), np.float32),
                                         mc.channel_first_latent)
            ode_samples = [[*sample_items, (mid, placeholder)]] * (2 if use_cfg else 1)
            packed = _sample_batch._width_bucket_pack(self, ode_samples)
            if use_cfg:
                # the uncond row: every text id nulled
                text = np.asarray(packed.text).copy()
                text[1] = np.where(text[1] >= 0, self.null_text_id, text[1])
                packed = packed.replace(text=text)

            # locate the current instance's rows in its group
            span_row = int((np.asarray(packed.spans[0, :, 2]) > 0).sum() - 1)
            gi = next(i for i, g in enumerate(packed.groups)
                      if g.modality_type == mid and g.latent_shape == spatial
                      and (np.asarray(g.span_rows) == span_row).any())
            g = packed.groups[gi]
            rows = np.nonzero(np.asarray(g.span_rows) == span_row)[0]
            batch_idx = np.asarray(g.batch_idx)[rows]
            row_cond = int(rows[batch_idx == 0][0])
            row_uncond = int(rows[batch_idx == 1][0]) if use_cfg else 0

            sampled = self._sample_ode_impl(
                packed.to_torch(self.device), noise, float(cfg_scale), gi=gi,
                row_cond=row_cond, row_uncond=row_uncond, span_row=span_row,
                steps=int(modality_steps), use_cfg=use_cfg)
            sample_items.append(
                (mid, to_user_layout(sampled.cpu().numpy(), mc.channel_first_latent)))
            sample_items.append(np.asarray([self.eom_ids[mid]], np.int32))
            curr_length += self.seq_len_for(mid, spatial)
            trigger = None

        return sample_items

    def _prefill_impl(self, packed, *, cap, quantize=False):
        """Fresh cache of capacity `cap`, prefilled with the packed batch
        (numpy PackedBatch). Returns (last real token's logits [b, vocab], cache)."""
        packed = packed.to_torch(self.device)
        b = packed.batch
        cache = self._cache(b, cap, quantize, track_mask=True)
        cache["mask"] = torch.arange(cap, device=self.device)[None, :] < packed.lengths[:, None]
        times = torch.ones((b, packed.spans.shape[1]), device=self.device)
        logits, _, _, _, new_cache = self.core.joint(packed, times, cache=cache)
        last = logits[torch.arange(b, device=self.device), packed.lengths - 1]
        return last, new_cache

    def _decode_text_impl(self, cache, tok, pos, generator, *, temperature, min_p):
        cache = cache_mark_valid(
            cache, torch.ones((tok.shape[0], 1), dtype=torch.bool, device=self.device)
        )
        logits, cache = self.core.decode_text_step(tok, pos, cache)
        last = logits[0, -1].float()
        tok_next = gumbel_sample(min_p_filter(last, min_p), temperature, generator)
        return tok_next, last, cache

    def _ode_cached_impl(self, cond_cache, uncond_cache, noise, p0, cfg_scale, *,
                         modality_type, L, steps, use_cfg, rows=1):
        """Tail-only CFG ODE over the cached history. rows=1: cond (and with
        use_cfg a separate uncond cache); rows=2: one batch-2 cache holding
        [cond, uncond], the guidance pair as one batched forward. Each flow
        evaluation writes its rows' K/V into the cache slots after idx (the
        returned cache is dropped, so idx does not move)."""
        rotary = torch.full((rows, L), p0, dtype=torch.int64, device=self.device)
        valid = torch.ones((rows, L), dtype=torch.bool, device=self.device)

        def flow(t, y):
            cc = cache_mark_valid(cond_cache, valid)
            y_in = y[None].expand(rows, *y.shape)
            f, _ = self.core.decode_modality_rows(y_in, t, rotary, cc, modality_type)
            if not use_cfg:
                return f[0]
            if rows == 2:
                f_c, f_u = f[0], f[1]
            else:
                uc = cache_mark_valid(uncond_cache, valid)
                f_u, _ = self.core.decode_modality_rows(y[None], t, rotary, uc, modality_type)
                f_c, f_u = f[0], f_u[0]
            return f_u + cfg_scale * (f_c - f_u)

        grid = torch.linspace(0.0, 1.0, steps, dtype=torch.float32)
        return odeint(flow, noise, grid, method=self.odeint_method)

    def _append_modality_impl(self, cache, y, p0, *, modality_type, L, rows=1):
        cache = cache_mark_valid(
            cache, torch.ones((rows, L), dtype=torch.bool, device=self.device)
        )
        rotary = torch.full((rows, L), p0, dtype=torch.int64, device=self.device)
        y_in = y[None].expand(rows, *y.shape)
        _, cache = self.core.decode_modality_rows(y_in, 1.0, rotary, cache, modality_type)
        return cache

    def _sample_cached(self, sample_items, generator, max_length, text_temperature,
                       text_min_p, fixed_modality_shape, init_modality_noise, modality_steps,
                       cfg_scale, kv_quantize=None, incremental_cfg=True):
        """The KV-cached sampling loop (same order of operations as the JAX
        `_sample_cached`). With incremental_cfg the cond and uncond streams
        share one batch-2 cache; otherwise the uncond stream is re-prefilled
        per modality segment."""
        use_cfg = cfg_scale != 1.0
        rows = 2 if (use_cfg and incremental_cfg) else 1
        uncond_of = functools.partial(_sample_batch._uncond_of, self)
        seq_stats = functools.partial(_sample_batch._seq_stats, self)

        tok_count, collapse = seq_stats(sample_items)
        cap = int(round_up_to_multiple(tok_count + max_length + 256 + 2, 128))
        kv_quantize = self._plan(cap, 1, kv_quantize).kv_quantize

        def prefill(items, this_cap):
            batch_items = [items]
            if rows == 2:
                batch_items.append(uncond_of(items))
            packed = self.pack(batch_items, wrap_sos_eos=False, add_meta=False)
            return self._prefill_impl(packed, cap=this_cap, quantize=kv_quantize)

        def packed_len(items):
            return self.pack([items], wrap_sos_eos=False, add_meta=False).seq_len

        last_logits, cache = prefill(sample_items, cap)
        slots_used = packed_len(sample_items)  # the cache idx after prefill

        curr_length = 0
        pending_tok: Optional[int] = None  # sampled but not yet in the cache

        def stream_pending(tok_to_stream):
            """Write the pending token into the cache; returns the next token."""
            nonlocal cache, tok_count, slots_used
            pos = tok_count - collapse
            toks = [[tok_to_stream]]
            if rows == 2:
                toks.append([self.null_text_id])  # the uncond row streams null
            tok_next, _, cache = self._decode_text_impl(
                cache, self._ids(toks), self._ids([[pos]] * rows), generator,
                temperature=float(text_temperature), min_p=float(text_min_p),
            )
            tok_count += 1
            slots_used += 1
            return int(tok_next)

        trigger = self._modality_trigger(sample_items, fixed_modality_shape)
        while curr_length <= max_length:
            if trigger is None:
                if pending_tok is None:
                    filtered = min_p_filter(last_logits[0].float(), text_min_p)
                    tok = int(gumbel_sample(filtered, text_temperature, generator))
                else:
                    tok = stream_pending(pending_tok)
                pending_tok = tok
                last = sample_items[-1]
                if isinstance(last, tuple):
                    sample_items.append(np.asarray([tok], np.int32))
                else:
                    sample_items[-1] = np.concatenate([last, np.asarray([tok], np.int32)])
                curr_length += 1
                if tok == self.eos_id:
                    break
                trigger = self._modality_trigger(sample_items, fixed_modality_shape)
                continue

            mid, spatial = trigger
            mc = self.modalities[mid]
            L = self.seq_len_for(mid, spatial)

            if pending_tok is not None:
                stream_pending(pending_tok)
                pending_tok = None

            if slots_used + L + 2 > cap:
                # capacity exhausted: rebuild the cache at a larger size
                cap = int(round_up_to_multiple(slots_used + L + 256, 128))
                last_logits, cache = prefill(sample_items, cap)
                slots_used = packed_len(sample_items)

            p0 = tok_count - collapse
            noise = self._segment_noise(init_modality_noise, spatial, mid, generator)

            uncond_cache = None
            if use_cfg and rows == 1:
                uncond_items = uncond_of(sample_items)
                u_tok, _ = seq_stats(uncond_items)
                _, uncond_cache = prefill(uncond_items, int(round_up_to_multiple(u_tok + L + 2, 128)))

            sampled = self._ode_cached_impl(
                cache, uncond_cache, noise, p0, float(cfg_scale), modality_type=mid, L=L,
                steps=int(modality_steps), use_cfg=use_cfg, rows=rows,
            )
            cache = self._append_modality_impl(cache, sampled, p0, modality_type=mid, L=L,
                                               rows=rows)
            sample_items.append(
                (mid, to_user_layout(sampled.cpu().numpy(), mc.channel_first_latent))
            )
            sample_items.append(np.asarray([self.eom_ids[mid]], np.int32))
            tok_count += L
            collapse += L - 1
            slots_used += L
            curr_length += L
            pending_tok = self.eom_ids[mid]  # streamed by the next text step
            trigger = None

        return sample_items
