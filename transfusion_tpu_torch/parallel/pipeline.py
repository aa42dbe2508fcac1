"""Pipeline parallelism: the transformer's blocks split into `pipe`
contiguous stages, microbatches flowing from stage to stage on the GPipe
schedule (counterpart of `transfusion_tpu/parallel/pipeline.py`).

The schedule is JAX's (M + P - 1)-tick loop (`pipeline.py:286-322`): at
tick t, stage 0 takes microbatch t and stage r runs microbatch t - r, then
hands its carry (activations, first-layer values) to stage r + 1. The
carry's third member in JAX, the valid flag, is the stage index here: stage
0 starts with no values (layer 0 makes them and feeds later layers its own,
having no value-residual mix), every later stage receives them. A stage
computes only its M real ticks; JAX computes the fill and drain ticks too
and masks them with `where`, so skipping them changes no number
(`pipeline_blocks.stage_calls` counts what ran).

A stage is a contiguous slice of the port's own `core.transformer` blocks
(`Transformer.run_stage`), run on the blocks' parameters under their own
names. JAX stacks the blocks into one [depth, ...] tree and injects a zero
mix for layer 0 (`stack_block_params`, `:68-135`) only because a flax
`scan` needs one tree shape; the port needs neither, so `load_flax`,
checkpoints and `shard_params` work as they are.

The value-residual carry is [mb, n, h*d] on the token-major route and
[mb, h, n, d] otherwise, decided by the attention's own router
(`Attention.route`, the counterpart of JAX's `attention_uses_nhd`), which
`Transformer.value_carry_shape` asks.

The backward: JAX differentiates through the schedule (ppermute transposes
to the reverse rotation). The port keeps each (stage, microbatch) forward
graph and runs explicit backward ticks in reverse order, each stage calling
`torch.autograd.grad` of its microbatch's output given the cotangent it
received, so autograd never crosses a rank and no node waits on another
process. The gradients are the same. `remat` / `remat_policy` are taken
per block, as JAX's `jax.checkpoint` around each layer (`:265-274`).

The last stage's outputs go to every rank (JAX's `psum` over 'pipe',
`:323-327`), so embed-in, the head and the loss run alike on every rank.
Their gradients are computed alike and are not summed over 'pipe'; only
the stages' gradients are: zeros for the layers a rank does not hold, then
one all-reduce, after which every rank holds the whole gradient, as JAX's
pipe-replicated parameters do. The trunk input's and the conditioning's
gradients are summed over 'pipe' in the same all-reduce.

Rows: every rank is handed the whole batch; on a 'data' axis each rank
runs its contiguous share of the rows (split into the M microbatches) and
the outputs, the trunk input's and the conditioning's gradients are
all-gathered over 'data', the stages' gradients summed over it, so the
loss and every gradient come out whole and alike on every rank, as JAX's
global view has them. Other mesh axes (fsdp, tensor) replicate the rows:
each stage computes on whole weights, as JAX's `P('pipe')` `in_specs`
hand a stage the gathered tensor.

Where the stages run:
  * `MeshStages(mesh)`: one stage per rank of the mesh's 'pipe' axis
    (`Trainer(mesh=)`, `loss(pipeline=(mesh, M))`); a tick's carries go
    out in one `comm.exchange` (`dist.batch_isend_irecv`: NCCL on the
    card, gloo on the CPU);
  * `LocalStages(P)`: all P stages in this one process, on one device, the
    carries handed over in memory. It runs the same schedule code (only
    `exchange` and the reductions differ): the port's counterpart of the
    JAX tests' virtual CPU devices, and what one card can run. The
    `Trainer` takes only a real mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from transfusion_tpu_torch.parallel import comm
from transfusion_tpu_torch.parallel.mesh import axis_of


class LocalStages:
    """P pipeline stages in this process: `loss(pipeline=(LocalStages(P),
    M[, schedule]))`. A tick's carries are handed over in memory; the sums
    over stages are sums over the stages' parts."""

    data = comm.SINGLE

    def __init__(self, pipe: int):
        if pipe < 1:
            raise ValueError(f"LocalStages({pipe}): at least one stage")
        self.size = pipe
        self.stages = tuple(range(pipe))

    def exchange(self, sends: dict, recvs: dict) -> dict:
        """{(src, dst): tensors} -> {(src, dst): tensors} received."""
        if set(sends) != set(recvs):
            raise RuntimeError(f"pipeline schedule mismatch: sends {sorted(sends)}, "
                               f"receives {sorted(recvs)}")
        return {k: list(sends[k]) for k in recvs}

    def sum_over_stages(self, parts: dict, shapes: dict, device) -> dict:
        """{key: the sum over stages of parts[stage][key]} in float32 (a key
        a stage lacks is zero there)."""
        out = {}
        for key, shape in shapes.items():
            have = [parts[r][key].float() for r in self.stages if key in parts.get(r, {})]
            out[key] = (torch.stack(have).sum(0) if len(have) > 1 else have[0] if have
                        else torch.zeros(shape, dtype=torch.float32, device=device))
        return out

    def from_stage(self, src: int, parts: dict, spec):
        return parts[src]


class MeshStages:
    """One stage per rank of the mesh's 'pipe' axis."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.pipe, self.data = axis_of(mesh, "pipe"), axis_of(mesh, "data")
        self.size = self.pipe.size
        self.stages = (self.pipe.rank,)
        if self.size > 1:
            # every rank of the group takes part in its first collective, which
            # NCCL asks of a group before its first batched point-to-point call
            dist.barrier(group=self.pipe.group)

    def exchange(self, sends: dict, recvs: dict) -> dict:
        me = self.pipe.rank
        got = comm.exchange({dst: xs for (src, dst), xs in sends.items() if src == me},
                            {src: specs for (src, dst), specs in recvs.items() if dst == me},
                            self.pipe)
        return {(src, me): xs for src, xs in got.items()}

    def sum_over_stages(self, parts: dict, shapes: dict, device) -> dict:
        mine = parts.get(self.pipe.rank, {})
        flat = torch.cat([(mine[k].float() if k in mine else torch.zeros(
            shape, dtype=torch.float32, device=device)).reshape(-1)
            for k, shape in shapes.items()])
        flat = comm.all_reduce_sum(flat, self.pipe)
        sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
        return {k: t.view(shape) for (k, shape), t in zip(shapes.items(), flat.split(sizes))}

    def from_stage(self, src: int, parts: dict, spec):
        """The tensor of stage `src` on every rank (a broadcast)."""
        if self.size == 1:
            return parts[src]
        shape, dtype, device = spec
        t = (parts[src].contiguous() if self.pipe.rank == src
             else torch.empty(shape, dtype=dtype, device=device))
        dist.broadcast(t, src=dist.get_global_rank(self.pipe.group, src), group=self.pipe.group)
        return t


def as_stages(where):
    """A `pipeline=` tuple's first member as stages: a `LocalStages`, or a
    mesh (`parallel.make_mesh`) with a 'pipe' axis."""
    if isinstance(where, LocalStages):
        return where
    if "pipe" not in getattr(where, "mesh_dim_names", ()):
        raise ValueError("mesh needs a 'pipe' axis (make_mesh)")
    return MeshStages(where)


def check_pipelinable(transformer):
    """The stack constraints of the JAX `pipeline_transformer_forward`."""
    if transformer.unet_skips is not False:
        raise ValueError("pipeline requires unet_skips=False")
    if transformer.streams != 1:
        raise ValueError("pipeline requires num_residual_streams=1")
    if transformer.dropout != 0.0:
        raise ValueError("pipeline requires dropout=0")


# ---------------------------------------------------------------------------
# rows and microbatches
# ---------------------------------------------------------------------------


class Rows:
    """The microbatch split of one call: the rank's rows [lo, lo + b_l) of
    the whole batch b, in M microbatches of mb rows."""

    def __init__(self, b: int, microbatches: int, data: comm.Axis):
        if b % data.size:
            raise ValueError(f"a batch of {b} rows does not split over data={data.size}")
        self.b, self.M, self.data = b, microbatches, data
        self.b_l = b // data.size
        if self.b_l % microbatches:
            raise ValueError(f"batch {b} % microbatches {microbatches} != 0"
                             + (f" on each of data={data.size} ranks" if data.size > 1 else ""))
        self.mb = self.b_l // microbatches
        self.lo = data.rank * self.b_l

    def mb_slice(self, f: int) -> slice:
        return slice(f * self.mb, (f + 1) * self.mb)

    def local(self, t):
        """This rank's rows of a whole-batch tensor (None, a bool, or a
        tensor without a batch dim of b rows, passes through)."""
        if not isinstance(t, torch.Tensor) or t.ndim == 0 or t.shape[0] != self.b:
            return t
        return comm.narrow_own(t, 0, self.data)

    def inputs(self, inputs: dict, f: int, cond=None) -> dict:
        """`Transformer.trunk_inputs` of the rank's rows, indexed to
        microbatch f; cond replaced by the given (microbatch) tensor."""
        sl = self.mb_slice(f)

        def rows(t):
            t = self.local(t)
            return (t if not isinstance(t, torch.Tensor) or t.ndim == 0 or t.shape[0] != self.b_l
                    else t[sl])

        spec = inputs["flash_spec"]
        if spec is not None:
            spec = dict(spec, spans=rows(spec.get("spans")))
        return dict(cond=cond, cond_index=rows(inputs["cond_index"]), mask=rows(inputs["mask"]),
                    rope=rows(inputs["rope"]) if inputs["rope"] is not None
                    and inputs["rope"].ndim > 2 else inputs["rope"],
                    is_any_modality=rows(inputs["is_any_modality"]), flash_spec=spec)


def stage_layers(depth: int, pipe: int, r: int) -> range:
    if depth % pipe:
        raise ValueError(f"depth {depth} % pipe {pipe} != 0")
    per = depth // pipe
    return range(r * per, (r + 1) * per)


def leaves(params: dict, grad: bool) -> dict:
    return {k: p.detach().requires_grad_(grad) for k, p in params.items()}


def grad_keys(layers, block_params: list):
    return [(i, k) for i in layers for k in block_params[i]]


def accumulate(parts: dict, key, t):
    """parts[key] += t, in float32."""
    parts[key] = parts[key] + t.float() if key in parts else t.float()


def accumulate_rows(parts: dict, key, rows: slice, t, shape: tuple):
    """parts[key][rows] += t, parts[key] a float32 tensor of `shape`."""
    acc = parts.setdefault(key, torch.zeros(shape, device=t.device))
    acc[rows] += t.float()


# ---------------------------------------------------------------------------
# the GPipe engine
# ---------------------------------------------------------------------------


class _GPipeRun:
    """One call of the GPipe schedule: its forward ticks (keeping each
    stage's microbatch graphs when `keep`) and its backward ticks."""

    def __init__(self, transformer, stages, microbatches: int, inputs: dict,
                 block_params: list):
        self.t, self.stages, self.M = transformer, stages, microbatches
        self.inputs, self.block_params = inputs, block_params
        self.P = stages.size
        self.layers = {r: stage_layers(transformer.depth, self.P, r) for r in range(self.P)}

    def forward(self, x, cond, keep: bool):
        P, M, stages = self.P, self.M, self.stages
        b, n, dim = x.shape
        rows = self.rows = Rows(b, M, stages.data)
        mb = rows.mb
        x_l, c_l = rows.local(x), rows.local(cond)
        self.x_shape, self.cond_shape = tuple(x_l.shape), None if cond is None else tuple(
            c_l.shape)
        self.x_dtype, self.cond_dtype = x.dtype, None if cond is None else cond.dtype
        self.device = x.device
        specs = [((mb, n, dim), x.dtype, x.device),
                 (self.t.value_carry_shape(mb, n, self.inputs["flash_spec"]), x.dtype, x.device)]
        self.specs = specs
        self.leaves = {r: {i: leaves(self.block_params[i], keep) for i in self.layers[r]}
                       for r in stages.stages}
        self.saved = {}
        carry, outs = {}, [None] * M
        calls = pipeline_blocks.stage_calls
        for t in range(M + P - 1):
            sends, recvs = {}, {}
            for r in stages.stages:
                f = t - r
                if not 0 <= f < M:
                    continue  # a fill or drain tick: nothing to compute
                x_in, v_in = (x_l[rows.mb_slice(f)], None) if r == 0 else carry.pop(r)
                with torch.set_grad_enabled(keep):
                    x_in = x_in.detach().requires_grad_(keep)
                    v_in = None if v_in is None else v_in.detach().requires_grad_(keep)
                    c_in = None if c_l is None else c_l[rows.mb_slice(f)].detach(
                        ).requires_grad_(keep)
                    x_out, v_out = self.t.run_stage(x_in, v_in, self.layers[r], self.leaves[r],
                                                    rows.inputs(self.inputs, f, c_in))
                calls["forward"] += 1
                if keep:
                    self.saved[(r, f)] = (x_in, v_in, c_in, x_out, v_out)
                if r < P - 1:
                    sends[(r, r + 1)] = (x_out.detach(), v_out.detach())
                else:
                    outs[f] = x_out.detach()
            for r in stages.stages:
                if r > 0 and 0 <= t - (r - 1) < M:
                    recvs[(r - 1, r)] = specs
            for (src, dst), got in stages.exchange(sends, recvs).items():
                carry[dst] = tuple(got)
        last = {P - 1: torch.cat(outs)} if P - 1 in stages.stages else {}
        out = stages.from_stage(P - 1, last, ((rows.b_l, n, dim), x.dtype, x.device))
        return comm.all_gather_cat(out, 0, stages.data)

    def backward(self, g):
        """The cotangent of the whole output -> (dx, dcond, {(layer, name):
        grad}), each whole on every rank."""
        P, M, stages, rows = self.P, self.M, self.stages, self.rows
        g_l = rows.local(g)
        parts = {r: {} for r in stages.stages}
        cot = {}
        calls = pipeline_blocks.stage_calls
        for t in reversed(range(M + P - 1)):
            sends, recvs = {}, {}
            for r in stages.stages:
                f = t - r
                if not 0 <= f < M:
                    continue
                x_in, v_in, c_in, x_out, v_out = self.saved.pop((r, f))
                if r == P - 1:
                    outs, gouts = [x_out], [g_l[rows.mb_slice(f)].to(x_out.dtype)]
                else:
                    gx, gv = cot.pop(r)
                    outs, gouts = [x_out, v_out], [gx.to(x_out.dtype), gv.to(v_out.dtype)]
                names = grad_keys(self.layers[r], self.block_params)
                wrt = [x_in] + ([v_in] if v_in is not None else []) + (
                    [c_in] if c_in is not None else []) + [self.leaves[r][i][k] for i, k in names]
                grads = list(torch.autograd.grad(outs, wrt, gouts, allow_unused=True))
                grads = [torch.zeros_like(w) if gr is None else gr for w, gr in zip(wrt, grads)]
                calls["backward"] += 1
                dx_in = grads.pop(0)
                dv_in = grads.pop(0) if v_in is not None else None
                if c_in is not None:
                    accumulate_rows(parts[r], "dcond", rows.mb_slice(f), grads.pop(0),
                                    self.cond_shape)
                for key, gr in zip(names, grads):
                    accumulate(parts[r], key, gr)
                if r > 0:
                    sends[(r, r - 1)] = (dx_in, dv_in)
                else:
                    accumulate_rows(parts[r], "dx", rows.mb_slice(f), dx_in, self.x_shape)
            for r in stages.stages:
                if r < P - 1 and 0 <= t - (r + 1) < M:
                    recvs[(r + 1, r)] = self.specs
            for (src, dst), got in stages.exchange(sends, recvs).items():
                cot[dst] = tuple(got)
        return self._reduce(parts)

    def _reduce(self, parts):
        """The stages' parts summed over 'pipe' in one all-reduce; dx and
        dcond all-gathered over 'data', the parameter gradients summed over
        it."""
        data = self.stages.data
        shapes = {"dx": self.x_shape}
        if self.cond_shape is not None:
            shapes["dcond"] = self.cond_shape
        names = grad_keys(range(self.t.depth), self.block_params)
        shapes.update({key: tuple(self.block_params[key[0]][key[1]].shape) for key in names})
        total = self.stages.sum_over_stages(parts, shapes, self.device)
        dx = comm.all_gather_cat(total.pop("dx"), 0, data).to(self.x_dtype)
        dcond = total.pop("dcond", None)
        if dcond is not None:
            dcond = comm.all_gather_cat(dcond, 0, data).to(self.cond_dtype)
        grads = comm.all_reduce_dict(total, data)
        return dx, dcond, grads


class _GPipe(torch.autograd.Function):
    """(x, cond, block params) -> the trunk's output, on every rank; the
    backward runs the schedule's backward ticks."""

    @staticmethod
    def forward(ctx, run, keys, x, cond, *params):
        ctx.run, ctx.keys = run, keys
        ctx.dtypes = [p.dtype for p in params]
        return run.forward(x, cond, keep=True)

    @staticmethod
    def backward(ctx, g):
        dx, dcond, grads = ctx.run.backward(g)
        ctx.run = None
        return (None, None, dx, dcond,
                *(grads[key].to(dt) for key, dt in zip(ctx.keys, ctx.dtypes)))


def pipeline_blocks(transformer, stages, microbatches: int, x, inputs: dict,
                    block_params: list):
    """Run the blocks as `stages.size` stages on the GPipe schedule (the JAX
    `pipeline_blocks`, `pipeline.py:167-348`). x [b, n, dim] (the whole
    batch); inputs: `transformer.trunk_inputs` of it; block_params[i]:
    block i's parameters (differentiated when they require grad). Returns
    Float[b, n, dim] before the final norm, on every rank."""
    check_pipelinable(transformer)
    run = _GPipeRun(transformer, stages, microbatches, inputs, block_params)
    cond = inputs["cond"]
    keys = grad_keys(range(transformer.depth), block_params)
    flat = [block_params[i][k] for i, k in keys]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, cond, *flat)):
        return _GPipe.apply(run, keys, x, cond, *flat)
    with torch.no_grad():
        return run.forward(x, cond, keep=False)


# stage computations run by the schedules (fill and drain ticks compute
# nothing): reset and read them around a call
pipeline_blocks.stage_calls = {"forward": 0, "backward": 0}


def pipeline_transformer_forward(transformer, where, microbatches: int, x, times=None,
                                 times_inst=None, spans=None, causal: bool = False,
                                 is_any_modality=None, rotary_pos=None):
    """`Transformer.forward`'s uncached call, pipelined (the JAX
    `pipeline_transformer_forward`, `pipeline.py:463-528`): the trunk
    inputs once (replicated), the blocks on the GPipe schedule over `where`
    (a mesh with a 'pipe' axis, or `LocalStages`), then the final norm.
    The blocks run on their current parameters (under the trainer's
    `functional_call`, the compute-dtype casts of the masters)."""
    check_pipelinable(transformer)
    inputs = transformer.trunk_inputs(x, times=times, times_inst=times_inst, spans=spans,
                                      causal=causal, is_any_modality=is_any_modality,
                                      rotary_pos=rotary_pos)
    params = [dict(b.named_parameters()) for b in transformer.blocks]
    out = pipeline_blocks(transformer, as_stages(where), microbatches, x, inputs, params)
    return transformer.final_norm(out)
