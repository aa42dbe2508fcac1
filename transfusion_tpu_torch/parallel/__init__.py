from transfusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    order_devices_for_dcn,
    param_partition_spec,
    shard_params,
)
from transfusion_tpu_torch.parallel.pipeline import LocalStages

__all__ = ["LocalStages", "batch_sharding", "initialize_distributed", "make_mesh",
           "order_devices_for_dcn", "param_partition_spec", "shard_params"]
