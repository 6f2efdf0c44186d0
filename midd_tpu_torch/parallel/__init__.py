"""Parallelism of the port (counterpart of ``midd_tpu/parallel``):
data- and tensor-parallel training over ``torch.distributed``, one process
per rank, and the tensor-parallel layout of the serving engine, in one
process over local devices. ``image_sharding`` (sp) is not exported: it raises until
ROADMAP.md queue 1 item 15c ports it. ``host_local_batch_to_global`` has no
counterpart (``multihost``'s docstring says why)."""

from midd_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    count_tp_sharded,
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
from midd_tpu_torch.parallel.tp import (  # noqa: F401
    ColumnParallel,
    RankColumnParallel,
    gather_shards,
    shard_over_group,
    shard_params,
)
from midd_tpu_torch.parallel.train_dp import make_sharded_train_step  # noqa: F401
