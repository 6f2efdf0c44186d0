"""Parallelism of the port (counterpart of ``midd_tpu/parallel``):
data-, tensor- and spatial-parallel training over ``torch.distributed``,
one process per rank, and the tensor- and spatial-parallel layout of the
serving engine, in one process over local devices. ``host_local_batch_to_global``
has no counterpart (``multihost``'s docstring says why)."""

from midd_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    count_tp_sharded,
    image_sharding,
    make_mesh,
    mesh_layout,
    param_shardings,
    replicated,
)
from midd_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    make_hybrid_mesh,
    mesh_fabric_report,
    process_batch_slice,
)
from midd_tpu_torch.parallel.sp import (  # noqa: F401
    RankRowParallel,
    RowParallel,
    row_blocks,
    shard_rows,
    shard_rows_over_group,
)
from midd_tpu_torch.parallel.tp import (  # noqa: F401
    ColumnParallel,
    RankColumnParallel,
    gather_shards,
    shard_over_group,
    shard_params,
)
from midd_tpu_torch.parallel.train_dp import make_sharded_train_step  # noqa: F401
