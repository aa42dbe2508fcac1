"""Device mesh and placement rules (counterpart of
`transfusion_tpu/parallel/mesh.py`), on `torch.distributed`.

  axes: 'data'    batch rows; gradients summed over it (each rank's loss is
                  its share of the global mean: the loss divides by the
                  whole batch's denominators)
        'fsdp'    the float32 masters, the optimizer state and the EMA are
                  stored sharded; gathered before the loss, gradients
                  reduce-scattered
        'tensor'  Megatron-style compute sharding: column-parallel kernels
                  keep their output columns (heads, the GEGLU inner width),
                  row-parallel ones all-reduce their partial products, the
                  vocab is split for `text_embed` and `to_text_logits`
        'context' the sequence inside attention (`parallel/context.py`)
        'pipe'    pipeline stages (`parallel/pipeline.py`, `parallel/pipeline_1f1b.py`)

JAX annotates shardings and lets GSPMD insert the collectives; here the
port inserts them: `models/layers.py` and `models/transformer.py` compute
on the tensor-local weights they are handed (`parallel/comm.py`'s f / g
around the sharded products), and `training/trainer.py` gathers and
reduces around the loss.

Placement rules are JAX's, by name: `param_partition_spec` reads a port
name as its flax path (`.weight` of an `nn.Linear` as `/kernel`, of the
embedding as `/embedding`) and swaps the dims of a Linear weight ([out,
in], where flax has [in, out]). `shard_params` adds what the port's
compute needs on top of `_feasible_spec`: a 'tensor' dim is kept only when
whole heads (attention) or whole halves of the GEGLU inner width
(feedforward) land on each rank; the fused [q | k] and [h | gates]
matrices split each half (`tensor_layout`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from transfusion_tpu_torch.parallel import comm

AXES = ("data", "fsdp", "tensor", "context", "pipe")
COLUMN_PARALLEL = ("to_qk", "to_v", "proj_in", "to_time_cond", "skip_proj")
ROW_PARALLEL = ("to_out", "proj_out")
# fused matrices whose rows are two halves, each split over 'tensor'
_HALVES = ("attn.to_qk.weight", "ff.proj_in.weight")
# attention kernels split over 'tensor' by whole heads
_HEAD_SPLIT = ("attn.to_qk.weight", "attn.to_v.weight", "attn.to_out.weight",
               "attn.to_value_residual_mix.weight")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, local_device_ids=None,
                           device: str = "cuda"):
    """Join the process group once per process; returns (rank, world size).

    Defaults come from `torchrun`'s environment (MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK). `coordinator_address` is 'host:port' or
    an init-method URL ('tcp://...', 'file://...'). NCCL on `device='cuda'`
    (each process takes the card LOCAL_RANK, or local_device_ids[0]), gloo
    on `device='cpu'`. A no-op when the group already exists."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r} ('cuda' or 'cpu')")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') needs a GPU; pass "
                               "device='cpu' for the gloo backend")
        local = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    init = coordinator_address
    if init is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError("no coordinator: run under torchrun or pass "
                             "coordinator_address='host:port'")
        init = f"tcp://{addr}:{port}"
    elif "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return dist.get_rank(), dist.get_world_size()


class RankDevice(NamedTuple):
    """A process of the group as `order_devices_for_dcn` sees it: its host
    (`process_index`, torchrun's GROUP_RANK) and its global rank (`id`)."""

    process_index: int
    id: int


def order_devices_for_dcn(devices, n: int):
    """Order devices so each host's are contiguous (by `process_index`,
    then `id`; anything with those attributes): with the C-order reshape in
    `make_mesh` the inner axes stay inside a host and only 'data' spans
    hosts. Returns the first n."""
    ordered = sorted(devices, key=lambda d: (getattr(d, "process_index", 0),
                                             getattr(d, "id", 0)))
    return ordered[:n]


def _process_devices():
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return [RankDevice(r // per_host, r) for r in range(world)]


def make_mesh(data: int = 1, fsdp: int = 1, tensor: int = 1, context: int = 1, pipe: int = 1,
              devices=None, device: Optional[str] = None):
    """A 5-axis `DeviceMesh` data x fsdp x tensor x context x pipe over the
    process group (joined with `initialize_distributed` if it is not yet),
    ranks in JAX's C order after `order_devices_for_dcn`. Its size must be
    the group's. `device`: the mesh's device type (default: 'cuda' on an
    NCCL group, else 'cpu')."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        initialize_distributed(device=device or "cuda")
    n = data * fsdp * tensor * context * pipe
    devices = devices if devices is not None else _process_devices()
    if n != dist.get_world_size() or len(devices) < n:
        raise ValueError(f"a {data}x{fsdp}x{tensor}x{context}x{pipe} mesh needs {n} ranks; "
                         f"the group has {dist.get_world_size()}")
    ranks = [d.id if hasattr(d, "id") else int(d) for d in order_devices_for_dcn(devices, n)]
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.tensor(ranks).reshape(data, fsdp, tensor, context, pipe),
                      mesh_dim_names=AXES)


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_of(mesh, name: str) -> comm.Axis:
    """One axis of the mesh as this rank sees it."""
    size = axis_size(mesh, name)
    if size == 1:
        return comm.SINGLE
    return comm.Axis(mesh.get_group(name), mesh.get_local_rank(name), size)


def _flax_name(name: str, ndim: int):
    """(the flax path JAX's rules read, whether the dims are swapped)."""
    if name.endswith(".weight") and ndim == 2:
        if name.startswith("text_embed."):
            return name[:-len(".weight")] + "/embedding", False
        return name[:-len(".weight")] + "/kernel", True
    return name, False


def param_partition_spec(name: str, p) -> tuple:
    """The mesh axis of each dim of parameter `name` (None: not split),
    JAX's `param_partition_spec` on the port's names and layouts."""
    flax, swap = _flax_name(name, p.ndim)
    spec = ()
    if p.ndim == 2:
        if "text_embed" in flax or "embedding" in flax:
            spec = ("tensor", "fsdp")
        elif "to_text_logits" in flax:
            spec = ("fsdp", "tensor")
        elif any(s in flax for s in COLUMN_PARALLEL) and "kernel" in flax:
            spec = ("fsdp", "tensor")
        elif any(s in flax for s in ROW_PARALLEL) and "kernel" in flax:
            spec = ("tensor", "fsdp")
        elif "kernel" in flax:
            spec = ("fsdp", None)
    return tuple(reversed(spec)) if swap and spec else spec


def _feasible_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop the split of any dim that its mesh axis does not divide."""
    return tuple(None if a is None or i >= len(shape) or shape[i] % axis_size(mesh, a)
                 else a for i, a in enumerate(spec))


def tensor_layout(name: str) -> str:
    """'halves' for the fused [q | k] / [h | gates] matrices (each half
    split over 'tensor'), else 'contiguous'."""
    return "halves" if name.endswith(_HALVES) else "contiguous"


def _drop(spec: tuple, axis: str) -> tuple:
    return tuple(None if a == axis else a for a in spec)


def shard_params(params: dict, mesh, heads: Optional[int] = None) -> dict:
    """{name: the axis of each dim} for the port's parameters on `mesh`:
    `_feasible_spec` of `param_partition_spec`, with 'tensor' dropped from
    an attention's kernels unless `heads` divides by it and from a
    feedforward's unless its inner width does (then the unit computes
    replicated, as its kernels are)."""
    tp = axis_size(mesh, "tensor")
    out = {k: _feasible_spec(param_partition_spec(k, p), tuple(p.shape), mesh)
           for k, p in params.items()}
    for k, p in params.items():
        if tp == 1 or "tensor" not in out[k]:
            continue
        if k.endswith(_HEAD_SPLIT) and (heads is None or heads % tp):
            out[k] = _drop(out[k], "tensor")
        if k.endswith(("ff.proj_in.weight", "ff.proj_out.weight")):
            inner = params[k.rsplit(".", 2)[0] + ".proj_out.weight"].shape[1]
            if inner % tp:
                out[k] = _drop(out[k], "tensor")
    return out


def set_tensor_axis(module, axis: comm.Axis):
    """Hand the 'tensor' axis to every submodule that computes on
    tensor-local weights (those with a `tp` attribute)."""
    for m in module.modules():
        if hasattr(type(m), "tp"):
            m.tp = axis


def tensor_partial(name: str, specs: dict) -> bool:
    """A parameter that 'tensor' replicates but whose module computes on
    its tensor-local slice (the bias of a column-parallel kernel, the
    per-head gates and value-mix bias): its gradient is partial on each
    rank and is summed over the axis."""
    for leaf, kernel in (("to_time_cond.bias", "to_time_cond.weight"),
                         ("ff.proj_in.bias", "ff.proj_in.weight"),
                         ("attn.to_value_residual_mix.bias", "attn.to_v.weight"),
                         ("attn.to_gates.weight", "attn.to_v.weight")):
        if name.endswith(leaf):
            return "tensor" in specs.get(name[:-len(leaf)] + kernel, ())
    return False


def _split_dim(x, dim: int, axis: comm.Axis, layout: str):
    if axis.size == 1:
        return x
    if layout == "halves":
        return torch.cat([comm.narrow_own(h, dim, axis) for h in x.chunk(2, dim)], dim)
    return comm.narrow_own(x, dim, axis)


def _join_dim(x, dim: int, axis: comm.Axis, layout: str):
    if axis.size == 1:
        return x
    if layout == "halves":
        return torch.cat([comm.all_gather_cat(h.contiguous(), dim, axis)
                          for h in x.chunk(2, dim)], dim)
    return comm.all_gather_cat(x, dim, axis)


def shard_tensor(name: str, full, spec: tuple, axes: dict):
    """This rank's stored shard of a whole parameter (or a tensor shaped
    like it): the tensor split first, then the fsdp split."""
    out = full
    for axis_name in ("tensor", "fsdp"):
        if axis_name in spec:
            layout = tensor_layout(name) if axis_name == "tensor" else "contiguous"
            out = _split_dim(out, spec.index(axis_name), axes[axis_name], layout)
    return out.contiguous()


def gather_fsdp(shard, spec: tuple, axes: dict):
    """The tensor-local parameter a rank computes with, from its shard."""
    if "fsdp" not in spec:
        return shard
    return comm.all_gather_cat(shard, spec.index("fsdp"), axes["fsdp"])


def unshard_tensor(name: str, shard, spec: tuple, axes: dict):
    """The whole parameter from every rank's shard."""
    out = gather_fsdp(shard, spec, axes)
    if "tensor" in spec:
        out = _join_dim(out, spec.index("tensor"), axes["tensor"], tensor_layout(name))
    return out


def batch_sharding(mesh, packed, draws=None):
    """This rank's rows of a packed batch (torch tensors) over 'data', and
    of its draws: text, cfg_mask, spans and lengths by row; each latent
    group keeps the instances of those rows (re-indexed; a group with none
    is dropped, with its noise); total_tokens stays the whole batch's.
    Returns (packed, draws) when draws are given."""
    ax = axis_of(mesh, "data")
    if ax.size == 1:
        return packed if draws is None else (packed, draws)
    b = packed.text.shape[0]
    if b % ax.size:
        raise ValueError(f"a batch of {b} rows does not split over data={ax.size}")
    lo, hi = ax.rank * (b // ax.size), (ax.rank + 1) * (b // ax.size)
    groups, keep = [], []
    for g in packed.groups:
        sel = (g.batch_idx >= lo) & (g.batch_idx < hi)
        keep.append(sel)
        if bool(sel.any()):
            groups.append(g.replace(latents=g.latents[sel], batch_idx=g.batch_idx[sel] - lo,
                                    offsets=g.offsets[sel], span_rows=g.span_rows[sel]))
    local = packed.replace(text=packed.text[lo:hi], cfg_mask=packed.cfg_mask[lo:hi],
                           spans=packed.spans[lo:hi], lengths=packed.lengths[lo:hi],
                           groups=tuple(groups))
    if draws is None:
        return local

    def per_group(noises):
        return tuple(n[sel] for n, sel in zip(noises, keep) if bool(sel.any()))

    draws = dataclasses.replace(draws, times=draws.times[lo:hi],
                                cfg_uniform=draws.cfg_uniform[lo:hi],
                                noises=per_group(draws.noises),
                                ema_noises=per_group(draws.ema_noises) if draws.ema_noises
                                else ())
    return local, draws
