"""The joint Transfusion loss through the 1F1B pipeline schedule
(counterpart of `transfusion_tpu/models/pipeline_loss.py`).

The 1F1B engine (`parallel/pipeline_1f1b.py`) computes the loss and every
gradient inside the schedule, so the loss must be written per microbatch.
This module builds that "head": the final RMSNorm, the text cross-entropy
and the per-modality flow / velocity-consistency / reconstruction terms,
written so that its sum over the microbatches is `Transfusion._loss_impl`'s
loss:

  * every mean is a sum times the inverse of the whole batch's
    denominator, from the port's `Transfusion.loss_denominators` (kept
    text labels, tokens per modality type, latent elements and instances
    per type): none depends on the trunk output;
  * each modality instance belongs to the microbatch whose contiguous
    slice of rows holds it; the other microbatches leave it out, so each
    is counted once across the schedule;
  * the x-prediction -> flow conversion recomputes the noised rows in
    model space from the noised latents inside the head, with
    `latent_to_model`'s parameters among the head's, so that projection
    keeps its gradient (the outer backward adds it to the embed-in path's,
    both views being the same parameter tensors);
  * the velocity term reads the EMA model's flows, from a forward-only
    GPipe pass over the same stages; the reconstruction term reads the
    groups' noise.

The loss's draws are the port's explicit `LossDraws`, as on every other
loss path.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from transfusion_tpu_torch.models.transfusion import LossBreakdown, _ce_chunk_sum
from transfusion_tpu_torch.ops.flow import model_output_to_flow, noise_data
from transfusion_tpu_torch.parallel.pipeline_1f1b import one_f_one_b_loss


def head_param_names(core) -> list:
    """The parameters the loss head reads (the JAX `_head_param_tree`): the
    text logits, the latent <-> model projections and the final norm's
    gamma."""
    return [k for k, _ in core.named_parameters()
            if k in ("to_text_logits.weight", "transformer.final_norm.gamma")
            or k.startswith(("latent_to_model.", "model_to_latent."))]


def block_param_dicts(params: dict, depth: int) -> list:
    """{name: tensor} per block, by the block's own names."""
    out = []
    for i in range(depth):
        pre = f"transformer.blocks.{i}."
        out.append({k[len(pre):]: v for k, v in params.items() if k.startswith(pre)})
    return out


def joint_loss_1f1b(model, params, packed, packed_in, labels, times, orig_times, draws,
                    scales: dict, ema_params, velocity_delta: float, where, microbatches: int):
    """`_loss_impl`'s joint loss through the 1F1B schedule (the JAX
    `joint_loss_1f1b`, `pipeline_loss.py:99-358`). packed: the batch before
    the shift and the CFG dropout; packed_in / labels: after them; times:
    the trained forward's (velocity-scaled) times, orig_times the drawn
    ones; scales: `loss_denominators` of the whole batch. Returns (total,
    LossBreakdown)."""
    core = model.core
    T = model.num_modalities
    cp = (model._compute_params(params) if params is not None
          else dict(core.named_parameters()))

    noised, flows = [], []
    for g, noise in zip(packed_in.groups, draws.noises):
        nz, fl = noise_data(g.latents, noise, times[g.batch_idx, g.span_rows])
        noised.append(nz)
        flows.append(fl)
    packed_n = packed_in.replace(groups=tuple(
        g.replace(latents=nz) for g, nz in zip(packed_in.groups, noised)))
    x, rotary_pos, _ = functional_call(core, cp, (packed_n,), {"method": "joint_embed_in"})
    inputs = functional_call(core, cp, (x,), {
        "method": "trunk_inputs", "times_inst": times, "spans": packed_n.spans,
        "rotary_pos": rotary_pos})

    ema_flows = None
    if ema_params is not None:
        # the EMA target sees the text before the CFG dropout
        with torch.no_grad():
            ema_flows = model._joint_core(
                ema_params, packed.replace(text=packed.text[:, :-1]),
                orig_times + velocity_delta, draws.ema_noises, return_logits=False,
                pipeline=(where, microbatches))[2]

    valid = model._valid_labels(labels, packed.spans)
    safe_labels = torch.where(valid, labels, 0)
    kept = scales["kept"]
    fracs = scales["type_token_counts"] / scales["total_tokens"]
    denoms = scales["elem_counts"].clamp_min(1.0)
    counts = scales["inst_counts"].clamp_min(1.0)
    ce_scale = model.text_loss_weight * (kept / scales["total_tokens"]) / kept.clamp_min(1.0)
    flow_scale = model.flow_loss_weight * fracs / denoms
    vel_scale = model.velocity_consistency_loss_weight * fracs / denoms
    recon_scale = model.reconstruction_loss_weight * fracs / counts
    dev = x.device

    def head_fn(hp, out, f, row0):
        rows = slice(row0, row0 + out.shape[0])
        embed = functional_call(core.transformer.final_norm,
                                {"gamma": hp["transformer.final_norm.gamma"]},
                                (out,)).to(model.dtype)
        weight = hp["to_text_logits.weight"]
        if model.ce_chunk_size is not None:
            ce = model._chunked_ce({"to_text_logits.weight": weight}, embed,
                                   safe_labels[rows], valid[rows])
        else:
            ce = _ce_chunk_sum(core, embed, weight, safe_labels[rows], valid[rows])
        contrib = ce * ce_scale
        zero = torch.zeros((), device=dev)
        flow_sse, vel_sse, recon_sum = [zero] * T, [zero] * T, [zero] * T
        for gi, g in enumerate(packed.groups):
            sel = ((g.batch_idx >= row0) & (g.batch_idx < rows.stop)).nonzero()[:, 0]
            if sel.numel() == 0:
                continue  # the group's instances belong to other microbatches
            t = g.modality_type
            idx = g.offsets[sel, None] + torch.arange(g.seq_len, device=dev)[None, :]
            out_rows = embed[(g.batch_idx[sel] - row0)[:, None], idx]
            t_inst = times[g.batch_idx[sel], g.span_rows[sel]]
            if core.model_output_clean:
                rows_noised = functional_call(core, hp, (noised[gi][sel], t),
                                              {"method": "latent_to_seq"})[0]
                out_rows = model_output_to_flow(out_rows, rows_noised, t_inst, core.eps)
            pred = functional_call(core, hp, (out_rows, t, tuple(g.seq_shape)),
                                   {"method": "seq_to_latent"})
            sse = ((pred - flows[gi][sel]).float() ** 2).sum()
            flow_sse[t] = flow_sse[t] + sse
            contrib = contrib + sse * flow_scale[t]
            if ema_flows is not None:
                vs = ((pred - ema_flows[gi][sel]).float() ** 2).sum()
                vel_sse[t] = vel_sse[t] + vs
                contrib = contrib + vs * vel_scale[t]
            if model.has_recon_loss:
                t_b = t_inst.reshape(-1, *(1,) * (pred.ndim - 1))
                recon = draws.noises[gi][sel] + pred * (1.0 - t_b)
                rs = ((recon - noised[gi][sel]) ** 2).flatten(1).mean(1).sum()
                recon_sum[t] = recon_sum[t] + rs
                contrib = contrib + rs * recon_scale[t]
        aux = {"ce_sum": ce, "flow_sse": torch.stack(flow_sse)}
        if ema_flows is not None:
            aux["vel_sse"] = torch.stack(vel_sse)
        if model.has_recon_loss:
            aux["recon_sum"] = torch.stack(recon_sum)
        return contrib, aux

    aux_shapes = {"ce_sum": (), "flow_sse": (T,)}
    if ema_flows is not None:
        aux_shapes["vel_sse"] = (T,)
    if model.has_recon_loss:
        aux_shapes["recon_sum"] = (T,)
    total, aux = one_f_one_b_loss(
        core.transformer, where, microbatches, x, head_fn,
        {k: cp[k] for k in head_param_names(core)}, aux_shapes, inputs,
        block_param_dicts(cp, core.transformer.depth))

    flow = [aux["flow_sse"][t] / denoms[t] for t in range(T)]
    return total, LossBreakdown(
        total=total, text=aux["ce_sum"] / kept.clamp_min(1.0), flow=flow,
        velocity=([aux["vel_sse"][t] / denoms[t] for t in range(T)]
                  if ema_flows is not None else None),
        recon=([aux["recon_sum"][t] / counts[t] for t in range(T)]
               if model.has_recon_loss else None))
