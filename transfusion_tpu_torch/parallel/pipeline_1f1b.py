"""The 1F1B (one-forward-one-backward) pipeline schedule with the loss
computed inside it (counterpart of `transfusion_tpu/parallel/pipeline_1f1b.py`).

GPipe (`parallel/pipeline.py`) keeps every microbatch's stage graph until
the backward ticks, so its activation memory grows with the microbatch
count M. 1F1B (PipeDream-flush, Narayanan et al. 2021) runs each
microbatch's backward as soon as the last stage has its loss, so a rank
holds O(P) microbatches' inputs whatever M is.

The schedule is JAX's: T = M + 2(P - 1) ticks (`pipeline_1f1b.py:161-162`);
at tick t, stage r runs the forward of microbatch t - r and the backward
of microbatch t - 2(P - 1) + r, each only when it is a real microbatch.
  * Only the stage INPUTS are kept, in a ring buffer of W = 2P - 1 slots
    (slot (f + r) mod W, as JAX indexes it); the backward recomputes the
    stage from its saved input under `torch.enable_grad()` and calls
    `torch.autograd.grad`, the counterpart of JAX's `jax.vjp` recompute.
    `remat` / `remat_policy` apply to each block of that recompute.
  * The last stage runs the loss head (`head_fn`, `models/pipeline_loss.py`
    builds the joint loss's) in the same tick as its forward; the head's
    cotangent of the stage output seeds that microbatch's backward.
  * Loss, aux, the head's gradients, the stages' gradients, dx and dcond
    accumulate in float32. A tick's forward carries (+1) and backward
    cotangents (-1, in float32, as JAX carries them) go out in one
    exchange.
  * Reductions (`:398-412`): loss, aux and head gradients over 'pipe' and
    'data'; stage gradients over 'data', and over 'pipe' with zeros for the
    layers a rank does not hold, so every rank holds them all (JAX returns
    them sharded over 'pipe'); dx and dcond over 'pipe', then all-gathered
    over 'data' (JAX's `out_specs` reassemble them). Every rank is handed
    the whole batch and runs its contiguous share of the rows, as in
    `parallel/pipeline.py`.

`one_f_one_b_loss` wraps the schedule in a `torch.autograd.Function`
(JAX's `jax.custom_vjp`, `:462-531`): its forward runs the whole schedule
and keeps the gradients, its backward scales them by the loss cotangent,
so an outer `loss.backward()` composes with the embedding and the time
conditioning that produce x and cond, and pays no second pipeline pass.

Meshes: 'pipe', and 'data' optionally (`:113-117`); any other axis larger
than 1 is refused. The stages run where `parallel/pipeline.py` says
(`MeshStages` / `LocalStages`).
"""

from __future__ import annotations

import torch

from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.mesh import axis_size
from transfusion_tpu_torch.parallel.pipeline import (
    MeshStages,
    Rows,
    accumulate,
    accumulate_rows,
    as_stages,
    check_pipelinable,
    grad_keys,
    leaves,
    stage_layers,
)


def _check_mesh(stages, microbatches: int):
    if isinstance(stages, MeshStages):
        mesh = stages.mesh
        for ax in mesh.mesh_dim_names:
            size = axis_size(mesh, ax)
            if ax not in ("pipe", "data") and size != 1:
                raise ValueError("the 1F1B engine pipelines over 'pipe' and shards rows over "
                                 f"'data' only — axis {ax}={size} must be size 1")
    if microbatches < stages.size:
        raise ValueError(f"microbatches {microbatches} must be >= pipe {stages.size}")


def pipeline_1f1b_grads(transformer, stages, microbatches: int, x, head_fn, head_params: dict,
                        aux_shapes: dict, inputs: dict, block_params: list):
    """Run the 1F1B schedule (the JAX `pipeline_1f1b_grads`,
    `pipeline_1f1b.py:86-460`). x [b, n, dim]: the whole batch's trunk
    input; inputs: `transformer.trunk_inputs` of it (its cond
    differentiated); block_params[i]: block i's parameters; head_fn(hp,
    out_mb, f, row0) -> (loss contribution, {name: float32 tensor}) for
    microbatch f's trunk output out_mb (float32, the rank's rows of it;
    row0 the whole batch's index of its first row), hp: head_params as
    leaves; aux_shapes: {name: shape} of the aux it returns. Returns
    (loss, aux, dx, dcond, {(layer, name): grad}, {name: head grad}): the
    gradients of the sum of head_fn over the microbatches, whole on every
    rank, float32."""
    check_pipelinable(transformer)
    _check_mesh(stages, microbatches)
    P, M = stages.size, microbatches
    W, T = 2 * P - 1, microbatches + 2 * (P - 1)
    b, n, dim = x.shape
    rows = Rows(b, M, stages.data)
    mb, dev = rows.mb, x.device
    cond = inputs["cond"]
    x_l, c_l = rows.local(x), rows.local(cond)
    layers = {r: stage_layers(transformer.depth, P, r) for r in range(P)}
    v_shape = transformer.value_carry_shape(mb, n, inputs["flash_spec"])
    fwd_specs = [((mb, n, dim), x.dtype, dev), (v_shape, x.dtype, dev)]
    bwd_specs = [((mb, n, dim), torch.float32, dev), (v_shape, torch.float32, dev)]
    stage_leaves = {r: {i: leaves(block_params[i], True) for i in layers[r]}
                    for r in stages.stages}
    head_leaves = leaves(head_params, True)
    buf = {r: [None] * W for r in stages.stages}
    fwd_carry, bwd_carry = {}, {}
    parts = {r: {} for r in stages.stages}
    calls = pipeline_1f1b_grads.stage_calls

    for t in range(T):
        sends, recvs = {}, {}
        for r in stages.stages:
            head_seed = None
            f = t - r
            if 0 <= f < M:  # the forward of microbatch f
                x_in, v_in = (x_l[rows.mb_slice(f)], None) if r == 0 else fwd_carry.pop(r)
                slot = (f + r) % W
                if buf[r][slot] is not None:
                    raise RuntimeError(f"1F1B ring buffer slot {slot} of stage {r} still held")
                buf[r][slot] = (x_in, v_in)
                c_in = None if c_l is None else c_l[rows.mb_slice(f)]
                with torch.no_grad():
                    x_out, v_out = transformer.run_stage(
                        x_in, v_in, layers[r], stage_leaves[r], rows.inputs(inputs, f, c_in))
                calls["forward"] += 1
                if r < P - 1:
                    sends[(r, r + 1)] = (x_out, v_out)
                else:  # the loss head, in the same tick
                    out = x_out.float().requires_grad_(True)
                    with torch.enable_grad():
                        contrib, aux = head_fn(head_leaves, out, f, rows.lo + f * mb)
                    names = list(head_leaves)
                    grads = torch.autograd.grad(contrib, [out] + [head_leaves[k] for k in names],
                                                allow_unused=True)
                    calls["head"] += 1
                    head_seed = grads[0]
                    accumulate(parts[r], "loss", contrib.detach())
                    for k, a in aux.items():
                        accumulate(parts[r], ("aux", k), a.detach())
                    for k, gr in zip(names, grads[1:]):
                        if gr is not None:
                            accumulate(parts[r], ("head", k), gr)
            fb = t - 2 * (P - 1) + r
            if 0 <= fb < M:  # the backward of microbatch fb
                if r == P - 1:
                    gx, gv = head_seed, None  # the head never reads the values
                else:
                    gx, gv = bwd_carry.pop(r)
                slot = (fb + r) % W
                x_s, v_s = buf[r][slot]
                buf[r][slot] = None
                with torch.enable_grad():
                    x_in = x_s.detach().requires_grad_(True)
                    v_in = None if v_s is None else v_s.detach().requires_grad_(True)
                    c_in = None if c_l is None else c_l[rows.mb_slice(fb)].detach(
                        ).requires_grad_(True)
                    x_out, v_out = transformer.run_stage(
                        x_in, v_in, layers[r], stage_leaves[r], rows.inputs(inputs, fb, c_in))
                outs, gouts = [x_out], [gx.to(x_out.dtype)]
                if gv is not None:
                    outs.append(v_out)
                    gouts.append(gv.to(v_out.dtype))
                names = grad_keys(layers[r], block_params)
                wrt = [x_in] + ([v_in] if v_in is not None else []) + (
                    [c_in] if c_in is not None else []) + [stage_leaves[r][i][k]
                                                           for i, k in names]
                grads = [torch.zeros_like(w) if gr is None else gr for w, gr in zip(
                    wrt, torch.autograd.grad(outs, wrt, gouts, allow_unused=True))]
                calls["backward"] += 1
                dx_in = grads.pop(0)
                dv_in = grads.pop(0) if v_in is not None else None
                if c_in is not None:
                    accumulate_rows(parts[r], "dcond", rows.mb_slice(fb), grads.pop(0),
                                    tuple(c_l.shape))
                for key, gr in zip(names, grads):
                    accumulate(parts[r], key, gr)
                if r > 0:
                    sends[(r, r - 1)] = (dx_in.float(), dv_in.float())
                else:  # stage 0's input cotangent is the trunk input's gradient
                    accumulate_rows(parts[r], "dx", rows.mb_slice(fb), dx_in, tuple(x_l.shape))
        for r in stages.stages:
            if r > 0 and 0 <= t - (r - 1) < M:
                recvs[(r - 1, r)] = fwd_specs
            if r < P - 1 and 0 <= t - 2 * (P - 1) + r + 1 < M:
                recvs[(r + 1, r)] = bwd_specs
        for (src, dst), got in stages.exchange(sends, recvs).items():
            (fwd_carry if src < dst else bwd_carry)[dst] = tuple(got)

    # ---- reductions ----------------------------------------------------
    shapes = {"loss": ()}
    shapes.update({("aux", k): tuple(s) for k, s in aux_shapes.items()})
    shapes.update({("head", k): tuple(p.shape) for k, p in head_params.items()})
    keys = grad_keys(range(transformer.depth), block_params)
    shapes.update({key: tuple(block_params[key[0]][key[1]].shape) for key in keys})
    shapes["dx"] = tuple(x_l.shape)
    if c_l is not None:
        shapes["dcond"] = tuple(c_l.shape)
    total = stages.sum_over_stages(parts, shapes, dev)
    dx = comm.all_gather_cat(total.pop("dx"), 0, stages.data)
    dcond = total.pop("dcond", None)
    if dcond is not None:
        dcond = comm.all_gather_cat(dcond, 0, stages.data)
    total = comm.all_reduce_dict(total, stages.data)
    loss = total.pop("loss")
    aux = {k: total[("aux", k)] for k in aux_shapes}
    dhead = {k: total[("head", k)] for k in head_params}
    dblocks = {key: total[key] for key in keys}
    return loss, aux, dx, dcond, dblocks, dhead


# stage and head computations of the schedule (fill and drain ticks compute
# nothing): reset and read them around a call
pipeline_1f1b_grads.stage_calls = {"forward": 0, "backward": 0, "head": 0}


class _OneFOneB(torch.autograd.Function):
    """(x, cond, block params, head params) -> (loss, *aux): the forward
    runs the whole schedule and keeps its gradients; the backward scales
    them by the loss cotangent."""

    @staticmethod
    def forward(ctx, run, x, cond, *params):
        loss, aux, grads = run(x, cond)
        ctx.grads = grads
        ctx.dtypes = [x.dtype, None if cond is None else cond.dtype] + [p.dtype for p in params]
        aux = tuple(aux)
        ctx.mark_non_differentiable(*aux)
        return (loss, *aux)

    @staticmethod
    def backward(ctx, g, *_):
        grads, ctx.grads = ctx.grads, None
        return (None, *(None if d is None else (g * d).to(dt)
                        for d, dt in zip(grads, ctx.dtypes)))


def one_f_one_b_loss(transformer, where, microbatches: int, x, head_fn, head_params: dict,
                     aux_shapes: dict, inputs: dict, block_params: list):
    """(loss, aux): the sum over microbatches of head_fn's contributions
    through the 1F1B schedule over `where` (a mesh with a 'pipe' axis, or
    `LocalStages`), differentiable in x, inputs['cond'], block_params and
    head_params; the gradients come from the schedule itself (the JAX
    `make_1f1b_loss`)."""
    stages = as_stages(where)
    keys = grad_keys(range(transformer.depth), block_params)
    names = list(head_params)

    def run(x, cond):
        loss, aux, dx, dcond, dblocks, dhead = pipeline_1f1b_grads(
            transformer, stages, microbatches, x, head_fn, head_params, aux_shapes,
            dict(inputs, cond=cond), block_params)
        return loss, aux.values(), [dx, dcond, *(dblocks[k] for k in keys),
                                    *(dhead[k] for k in names)]

    params = [block_params[i][k] for i, k in keys] + [head_params[k] for k in names]
    loss, *aux = _OneFOneB.apply(run, x, inputs["cond"], *params)
    return loss, dict(zip(aux_shapes, aux))
