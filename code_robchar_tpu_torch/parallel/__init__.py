"""Device-mesh sharding of the batch axes (controllers, restarts, streams,
agents): counterpart of code_robchar_tpu/parallel."""

from code_robchar_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    Mesh,
    make_mesh,
    sharded_mc_metrics,
    sharded_mc_sweep,
    sharded_run_batch,
    shard_batch,
)

__all__ = ["BATCH_AXIS", "Mesh", "make_mesh", "sharded_mc_metrics",
           "sharded_mc_sweep", "sharded_run_batch", "shard_batch"]
