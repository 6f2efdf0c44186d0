"""Data-parallel training of the port over ``torch.distributed``, one
process per rank (counterpart of ``midd_tpu/parallel``). The JAX package's
tp and sp names (``image_sharding``, ``param_shardings``, ``shard_params``,
``count_tp_sharded``) are not exported: they raise until ROADMAP.md queue 1
items 15b and 15c port them. ``host_local_batch_to_global`` has no
counterpart (``multihost``'s docstring says why)."""

from midd_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
)
from midd_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    make_hybrid_mesh,
    mesh_fabric_report,
    process_batch_slice,
)
from midd_tpu_torch.parallel.train_dp import make_sharded_train_step  # noqa: F401
