"""PyTorch port: the mesh's placement rules (`parallel/mesh.py`) against the
JAX package's, and the host-contiguous device order.

  * `param_partition_spec` on every parameter of a small model with fused
    projections, two residual streams and pos-emb MLPs equals JAX's spec on
    the flax path `weights.from_flax` maps it from, with the two dims
    swapped for an `nn.Linear` weight (torch [out, in], flax [in, out]);
  * `_feasible_spec` equals JAX's on an 8-device data 2 x fsdp 2 x tensor 2
    mesh;
  * `shard_params` keeps 'tensor' only on whole heads and whole GEGLU
    halves;
  * `order_devices_for_dcn` lays fake multi-host devices out host-contiguous,
    as `tests/test_training.py::test_dcn_device_ordering_multi_process`
    holds JAX's; `batch_sharding` keeps a data rank's rows and their latent
    instances and noises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu.parallel import make_mesh as j_make_mesh
from transfusion_tpu.parallel.mesh import _feasible_spec as j_feasible
from transfusion_tpu.parallel.mesh import param_partition_spec as j_spec
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.parallel import comm, mesh
from transfusion_tpu_torch.weights import _torch_key

CFG = dict(num_text_tokens=16, dim_latent=8, modality_default_shape=(4, 4), pad_multiple=16,
           add_pos_emb=True)
TCFG = dict(dim=32, depth=2, dim_head=16, heads=2, attn_impl="flash", fuse_projections=True,
            num_residual_streams=2)


class FakeMesh:
    """What `parallel/mesh.py` reads of a DeviceMesh, without a process
    group: the axis names and sizes."""

    mesh_dim_names = mesh.AXES

    def __init__(self, **sizes):
        self.sizes = [sizes.get(a, 1) for a in mesh.AXES]

    def size(self, i):
        return self.sizes[i]


def test_param_partition_spec_matches_jax():
    jm = JaxTransfusion(transformer=TCFG, **CFG)
    tree = jax.jit(lambda k: jm.core.init(k, method="init_all"))(jax.random.PRNGKey(0))
    tm = Transfusion(transformer=TCFG, device="cpu", **CFG)
    port = dict(tm.core.named_parameters())
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        name = _torch_key(keys)
        if name not in port:  # a buffer (the fixed fourier frequencies)
            continue
        want = tuple(j_spec(path, leaf))
        if keys[-1] == "kernel" and leaf.ndim == 2:
            want = tuple(reversed(want))
        assert mesh.param_partition_spec(name, port[name]) == want, name
        seen.add(name)
    assert seen == set(port)
    assert mesh.param_partition_spec("transformer.blocks.1.attn.to_qk.weight",
                                     port["transformer.blocks.1.attn.to_qk.weight"]) == (
        "tensor", "fsdp")
    assert mesh.param_partition_spec("text_embed.weight", port["text_embed.weight"]) == (
        "tensor", "fsdp")


@pytest.mark.parametrize("spec,shape", [
    (("fsdp", "tensor"), (64, 32)), (("tensor", "fsdp"), (7, 32)), (("fsdp", None), (5, 3)),
    (("tensor", "fsdp"), (166, 48)), ((), (4,)), (("fsdp", "tensor"), (6, 9)),
])
def test_feasible_spec_matches_jax(spec, shape):
    from jax.sharding import PartitionSpec as P

    want = tuple(j_feasible(P(*spec), shape, j_make_mesh(data=2, fsdp=2, tensor=2)))
    assert mesh._feasible_spec(spec, shape, FakeMesh(data=2, fsdp=2, tensor=2)) == want


def test_shard_params_keeps_whole_heads_and_halves():
    """heads 3 over tensor 2: the attention's kernels stay replicated (their
    [q | k] rows would divide, as JAX's `_feasible_spec` allows, but not by
    heads); inner width 85 (dim 32): the feedforward's too; the vocab (150)
    and to_time_cond (128 rows) split. A split of [q | k] takes each rank's
    rows of both halves."""
    tm = Transfusion(transformer=dict(TCFG, heads=3), device="cpu", **CFG)
    params = dict(tm.core.named_parameters())
    specs = mesh.shard_params(params, FakeMesh(tensor=2, fsdp=2), heads=3)
    blk = "transformer.blocks.1."
    assert specs[blk + "attn.to_qk.weight"] == (None, "fsdp")
    assert specs[blk + "attn.to_out.weight"] == ("fsdp", None)
    assert specs[blk + "ff.proj_in.weight"] == (None, "fsdp")
    assert specs["text_embed.weight"] == ("tensor", "fsdp")
    assert specs["transformer.to_time_cond.weight"] == ("tensor", None)  # 33 inputs
    specs2 = mesh.shard_params(params, FakeMesh(tensor=2), heads=2)
    assert mesh.tensor_partial(blk + "attn.to_gates.weight", specs2)
    assert not mesh.tensor_partial(blk + "attn.to_gates.weight", specs)
    full = torch.arange(8.0)[:, None].expand(8, 3)  # [q0 q1 q2 q3 | k0 k1 k2 k3]
    axes = {"tensor": comm.Axis(None, 1, 2), "fsdp": comm.SINGLE}
    local = mesh.shard_tensor("x.attn.to_qk.weight", full, ("tensor", None), axes)
    assert local[:, 0].tolist() == [2.0, 3.0, 6.0, 7.0]


def test_order_devices_for_dcn_fake_hosts():
    @dataclasses.dataclass(frozen=True)
    class FakeDev:
        process_index: int
        id: int

    devs = [FakeDev(p, i) for i in range(4) for p in range(2)]  # 2 hosts x 4, interleaved
    ordered = mesh.order_devices_for_dcn(devs, 8)
    assert [d.process_index for d in ordered] == [0] * 4 + [1] * 4
    assert [d.id for d in ordered[:4]] == [0, 1, 2, 3]
    arr = np.asarray(ordered, dtype=object).reshape(2, 1, 4, 1, 1)
    for d_idx in range(2):  # each data slice is one host
        assert len({dev.process_index for dev in arr[d_idx].flat}) == 1
    ranks = mesh.order_devices_for_dcn([mesh.RankDevice(r // 4, r) for r in (5, 1, 4, 0)], 4)
    assert [d.id for d in ranks] == [0, 1, 4, 5]


def test_batch_sharding_keeps_a_ranks_rows(monkeypatch):
    from tests.test_torch_training import samples

    tm = Transfusion(transformer=TCFG, device="cpu", **dict(CFG, add_pos_emb=False))
    packed = tm.pack(samples() + samples(1), shift_friendly=True).to_torch("cpu")
    draws = tm.make_draws(packed, torch.Generator().manual_seed(0))
    monkeypatch.setattr(mesh, "axis_of", lambda m, name: comm.Axis(None, 1, 2))
    local, d = mesh.batch_sharding(object(), packed, draws)
    assert torch.equal(local.text, packed.text[3:]) and torch.equal(d.times, draws.times[3:])
    assert len(local.groups) == len(packed.groups) == 2  # each group has rows on both ranks
    for g, gl, noise, full_noise in zip(packed.groups, local.groups, d.noises, draws.noises):
        sel = g.batch_idx >= 3
        assert torch.equal(gl.batch_idx, g.batch_idx[sel] - 3)
        assert torch.equal(gl.latents, g.latents[sel]) and torch.equal(noise, full_noise[sel])
