from transfusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    order_devices_for_dcn,
    param_partition_spec,
    shard_params,
)

__all__ = ["batch_sharding", "initialize_distributed", "make_mesh", "order_devices_for_dcn",
           "param_partition_spec", "shard_params"]
