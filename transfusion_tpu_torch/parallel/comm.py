"""Collectives over one axis of a device mesh, and the autograd functions
that carry gradients through them.

An `Axis` is one mesh axis as the calling rank sees it: its process group,
the rank's index along it and its size. Every function here is a no-op on
an axis of size 1, so a one-rank mesh runs the same code with no
communication.

The autograd functions differ in what their backward does, and each is
what `jax.shard_map`'s transpose rules give for the collective it stands
for:

  * `slice_seq` (a rank takes its slice of a replicated tensor): the
    backward all-gathers the slices' gradients, so every rank ends with the
    whole gradient;
  * `gather_seq` (all-gather of a result that is then replicated): the
    backward takes the rank's own slice of the (replicated) cotangent, with
    no reduction;
  * `gather_sum` (all-gather of operands whose gradients are partial on
    each rank): the backward reduce-scatters (sums) them, in float32;
  * `ring_pass` (each chunk travels around the ring): the backward sends
    each chunk's cotangent the other way, back to the chunk's owner,
    summing in float32;
  * `copy_to` / `reduce_from` (Megatron's f and g): identity forward with
    an all-reduce backward, and an all-reduce forward with an identity
    backward.

`exchange` is the pipeline's point-to-point step (`parallel/pipeline.py`):
one tick's sends and receives, posted together.

Tensors that go through one collective together go through one autograd
node, so that every rank runs its backward collectives in the same order.

On a gloo group the collectives take CUDA tensors as they are: gloo copies
them through host memory itself, so nothing here stages them. The mesh
Trainer's step uses `all_gather` and `all_reduce` only, which
`chip_smoke.py`'s phase "sharded optimizer" runs on 4 gloo ranks of one
card; `exchange`'s point-to-point ops on CUDA tensors over gloo are not
tried.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    group: Any  # the axis's process group (None when size is 1)
    rank: int  # this rank's index along the axis
    size: int


SINGLE = Axis(None, 0, 1)


def all_gather_cat(x, dim: int, axis: Axis):
    """The axis's tensors concatenated along `dim`, in axis order."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim)


def all_reduce_sum(x, axis: Axis):
    """The sum of x over the axis (a new tensor)."""
    if axis.size == 1:
        return x
    out = x.clone().contiguous()
    dist.all_reduce(out, group=axis.group)
    return out


def all_reduce_dict(xs: dict, axis: Axis) -> dict:
    """Each tensor of xs summed over the axis, in one all-reduce of their
    concatenation (they share a dtype)."""
    if axis.size == 1 or not xs:
        return xs
    keys = list(xs)
    flat = all_reduce_sum(torch.cat([xs[k].reshape(-1) for k in keys]), axis)
    return {k: t.view_as(xs[k]) for k, t in zip(keys, flat.split([xs[k].numel() for k in keys]))}


def narrow_own(x, dim: int, axis: Axis):
    """This rank's equal slice of x along `dim`."""
    if axis.size == 1:
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


def reduce_scatter_sum(x, dim: int, axis: Axis):
    """This rank's slice along `dim` of the sum of x over the axis."""
    if axis.size == 1:
        return x
    return narrow_own(all_reduce_sum(x, axis), dim, axis).contiguous()


class _SliceSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, *xs):
        ctx.axis, ctx.dim = axis, dim
        return tuple(narrow_own(x, dim, axis).contiguous() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *(all_gather_cat(g, ctx.dim, ctx.axis) for g in gs))


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, x):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_cat(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, narrow_own(g, ctx.dim, ctx.axis).contiguous()


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, *xs):
        ctx.axis, ctx.dim = axis, dim
        return tuple(all_gather_cat(x, dim, axis) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # the ranks' partial gradients summed in float32
        return (None, None, *(reduce_scatter_sum(g.float(), ctx.dim, ctx.axis).to(g.dtype)
                              for g in gs))


def exchange(sends: dict, recvs: dict, axis: Axis) -> dict:
    """One step of point-to-point traffic on the axis: sends {index along
    the axis: [tensors]} and recvs {index: [(shape, dtype, device)]}, all
    posted together in one `dist.batch_isend_irecv` and waited for. Posting
    a ring's sends and receives apart can deadlock it on NCCL, and on gloo
    past its eager size; posted together they cannot. Tensors between one
    pair of ranks arrive in the order they were sent. Returns {index:
    [received tensors]}."""
    ops, out = [], {}
    for dst, xs in sends.items():
        peer = dist.get_global_rank(axis.group, dst)
        ops += [dist.P2POp(dist.isend, x.contiguous(), peer, axis.group) for x in xs]
    for src, specs in recvs.items():
        peer = dist.get_global_rank(axis.group, src)
        out[src] = [torch.empty(shape, dtype=dtype, device=device)
                    for shape, dtype, device in specs]
        ops += [dist.P2POp(dist.irecv, o, peer, axis.group) for o in out[src]]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _shift(xs, axis: Axis, step: int):
    """Send each of xs to the rank `step` ahead on the axis and receive the
    same from the rank `step` behind."""
    to, frm = (axis.rank + step) % axis.size, (axis.rank - step) % axis.size
    return exchange({to: xs}, {frm: [(x.shape, x.dtype, x.device) for x in xs]}, axis)[frm]


class _RingPass(torch.autograd.Function):
    """(k, v) -> the chunks a rank holds at steps 0..P-1 of the ring: step i
    holds the chunk of rank (rank - i) mod P. All P - 1 rotations sit in
    this one node, so its backward runs on every rank (step 0's chunk is
    always used) and returns each chunk's gradient to its owner in P - 1
    reverse rotations, whichever chunks this rank's steps skipped."""

    @staticmethod
    def forward(ctx, axis, k, v):
        ctx.axis, ctx.dtypes = axis, (k.dtype, v.dtype)
        ks, vs = [k], [v]
        for _ in range(axis.size - 1):
            k, v = _shift((k, v), axis, 1)
            ks.append(k)
            vs.append(v)
        return (*ks, *vs)

    @staticmethod
    def backward(ctx, *gs):
        # each chunk's gradient sums its steps' partials in float32 on the
        # way home
        P = ctx.axis.size
        gk, gv = gs[P - 1].float(), gs[2 * P - 1].float()
        for i in range(P - 2, -1, -1):
            gk, gv = _shift((gk, gv), ctx.axis, -1)
            gk, gv = gk + gs[i].float(), gv + gs[P + i].float()
        return None, gk.to(ctx.dtypes[0]), gv.to(ctx.dtypes[1])


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, all_reduce_sum(g, ctx.axis)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return None, g


def slice_seq(xs, axis: Axis, dim: int = 2):
    """This rank's slices of the replicated tensors xs along `dim`."""
    return tuple(xs) if axis.size == 1 else _SliceSeq.apply(axis, dim, *xs)


def gather_seq(x, axis: Axis, dim: int = 2):
    """x from every rank along `dim`; the result is replicated."""
    return x if axis.size == 1 else _GatherSeq.apply(axis, dim, x)


def gather_sum(xs, axis: Axis, dim: int = 2):
    """xs from every rank along `dim`, each rank's use of them partial."""
    return tuple(xs) if axis.size == 1 else _GatherSum.apply(axis, dim, *xs)


def ring_pass(k, v, axis: Axis):
    """([k chunk at step i], [v chunk at step i]) for i in 0..P-1."""
    if axis.size == 1:
        return [k], [v]
    out = _RingPass.apply(axis, k.contiguous(), v.contiguous())
    return list(out[:axis.size]), list(out[axis.size:])


def copy_to(x, axis: Axis):
    """Megatron's f: x for a tensor-parallel region; its gradient is summed
    over the axis."""
    return x if axis.size == 1 else _CopyTo.apply(axis, x)


def reduce_from(x, axis: Axis):
    """Megatron's g: the sum of the axis's partial results."""
    return x if axis.size == 1 else _ReduceFrom.apply(axis, x)
