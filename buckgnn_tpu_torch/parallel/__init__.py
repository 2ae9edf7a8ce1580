"""Multi-device training (the port of buckgnn_tpu/parallel/): the mesh,
data parallelism, the edge-partitioned SAGE aggregation and the
tile-sharded EA stack, one process per card over torch.distributed. The
JAX package's ``stack_batches`` and ``shard_stacked_batch`` have no
counterpart here (parallel/dp.py says why); `local_batch` takes their
place."""

from buckgnn_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from buckgnn_tpu_torch.parallel.dp import (  # noqa: F401
    local_batch,
    make_parallel_train_step,
)
from buckgnn_tpu_torch.parallel.ea_shard import (  # noqa: F401
    EAShards,
    ea_tp_stack,
    pad_ea_shards,
    shard_caps,
    shard_ea_batch,
)
from buckgnn_tpu_torch.parallel.partitioned import (  # noqa: F401
    PartitionedBatch,
    pad_partitioned,
    partition_batch,
    partitioned_sage_aggregate,
)
