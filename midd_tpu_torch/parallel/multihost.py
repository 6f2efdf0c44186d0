"""Multi-process and multi-node layer of the port (counterpart of
``midd_tpu/parallel/multihost.py``).

The JAX package runs one process per host, each driving its local chips,
and lays the mesh out so that only the dp axis crosses the slower fabric
between slices. The port runs one process per rank (per card, or several
ranks sharing one card), launched by ``torchrun`` or by hand, and keeps the
same slice-major rank layout, a "slice" being a node: ``LOCAL_WORLD_SIZE``
ranks (or ``devices_per_slice``). Inside a node the ranks talk over NVLink,
between nodes over the network; ``mesh_fabric_report`` calls the two "ici"
and "dcn", as the JAX package does.

Pieces:
- ``init_distributed``: the process group from torchrun's variables or
  arguments (no-op when nothing is configured), NCCL or gloo;
- ``local_device``: this rank's card;
- ``make_hybrid_mesh``: the node-aware (dp, sp, tp) ``DeviceMesh``;
- ``process_batch_slice``: the rows of the global batch this rank loads.

The JAX package's ``host_local_batch_to_global`` has no counterpart: with
one process per rank there is no global array to assemble. Each rank loads
its own rows (``process_batch_slice``), and those rows are its shard of the
data-parallel step (``parallel/train_dp.py``), which reduces the gradients
across ranks.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from midd_tpu_torch.parallel.mesh import AXES, device_mesh, process_rows

# the JAX package's rendezvous bound (jax.distributed's default), here also
# the process group's bound on one collective
INIT_TIMEOUT_S = 300.0


def choose_backend() -> Tuple[str, str]:
    """(backend, reason): NCCL when every local rank has a card of its own,
    gloo on the CPU or when ranks share a card (NCCL refuses two ranks on
    one GPU)."""
    if not torch.cuda.is_available():
        return "gloo", "no CUDA device"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if cards >= local and dist.is_nccl_available():
        return "nccl", f"{local} local rank(s) on {cards} card(s), one each"
    return "gloo", f"{local} local ranks share {cards} card(s)"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[float] = None,
    backend: Optional[str] = None,
) -> bool:
    """Start the ``torch.distributed`` process group (one process per rank).

    Arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE``, ``RANK``. The address
    is ``host:port`` or an init URL (``tcp://``, ``file://``). ``backend``
    defaults to ``choose_backend``'s, and the choice is printed. Returns
    True when a process group was started, False when it already was or
    nothing is configured, so callers may use it unconditionally.

    A configured launch that cannot reach its coordinator raises within
    ``initialization_timeout`` seconds (``INIT_TIMEOUT_S``): falling through
    to independent single-process runs would train every rank on its rows
    alone with no gradient sync (wrong results, not an error)."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False  # single-process run; nothing to do
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a distributed launch needs the coordinator's address, the number of processes "
            f"and this process's rank; got {coordinator_address!r}, {num_processes}, {process_id}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    reason = "asked for"
    if backend is None:
        backend, reason = choose_backend()
    print(f"init_distributed: rank {process_id} of {num_processes}, backend {backend} ({reason})",
          flush=True)
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=initialization_timeout or INIT_TIMEOUT_S),
    )
    return True


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when the node has a card for
    every local rank, else the cards shared round-robin (one card: all ranks
    on it); made the current CUDA device. Other device types as given."""
    if device_type != "cuda":
        return torch.device(device_type)
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    device = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _ranks_per_slice(n: int, devices_per_slice: Optional[int]) -> int:
    """The explicit slice size, else a node's (``LOCAL_WORLD_SIZE``), else
    one slice of all ``n``."""
    if devices_per_slice is not None:
        return devices_per_slice
    return int(os.environ.get("LOCAL_WORLD_SIZE", n))


def hybrid_mesh_layout(tp: int = 1, sp: int = 1, ranks: Optional[Sequence[int]] = None,
                       devices_per_slice: Optional[int] = None) -> np.ndarray:
    """``make_hybrid_mesh``'s (dp, sp, tp) rank array: the ranks split into
    contiguous slices, every (sp, tp) block inside one slice, dp ordered
    slice-major so that only its outer stride crosses slices. With one slice
    this is ``mesh.mesh_layout``'s layout."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    n = len(ranks)
    if sp * tp == 0 or n % (sp * tp):
        raise ValueError(f"{n} devices not divisible by sp*tp={sp * tp}")
    per = _ranks_per_slice(n, devices_per_slice)
    if n % per:
        raise ValueError(f"{n} devices not divisible by slice size {per}")
    if per % (sp * tp):
        raise ValueError(
            f"slice size {per} not divisible by sp*tp={sp * tp}: the sp/tp "
            "axes must live inside one slice (a node), never across the network")
    per_dp = per // (sp * tp)
    return np.concatenate(
        [np.asarray(ranks[i : i + per]).reshape(per_dp, sp, tp) for i in range(0, n, per)], axis=0)


def make_hybrid_mesh(tp: int = 1, sp: int = 1, ranks: Optional[Sequence[int]] = None,
                     devices_per_slice: Optional[int] = None, device_type: str = "cuda"):
    """A (dp, sp, tp) ``DeviceMesh`` whose (sp, tp) blocks never cross a
    node (``hybrid_mesh_layout``); every rank of the process group calls it."""
    return device_mesh(hybrid_mesh_layout(tp, sp, ranks, devices_per_slice), device_type)


def process_batch_slice(global_batch: int, n_hosts: Optional[int] = None,
                        host_id: Optional[int] = None) -> Tuple[int, int]:
    """(start_row, n_rows) of the global batch THIS process should load;
    ``n_hosts`` and ``host_id`` default to the process group's size and this
    process's rank. Single-process: (0, global_batch)."""
    initialized = dist.is_initialized()
    n_hosts = (dist.get_world_size() if initialized else 1) if n_hosts is None else n_hosts
    host_id = (dist.get_rank() if initialized else 0) if host_id is None else host_id
    return process_rows(global_batch, n_hosts, host_id)


def mesh_fabric_report(mesh, devices_per_slice: Optional[int] = None) -> Dict[str, str]:
    """Which axes cross a node boundary ("dcn") and which stay inside a node
    ("ici"), for a ``DeviceMesh`` or a (dp, sp, tp) rank array. An axis
    crosses when two ranks that differ only along it sit in different
    slices (``devices_per_slice`` ranks, else ``LOCAL_WORLD_SIZE``, else
    all)."""
    ranks = np.asarray(mesh.mesh.tolist() if hasattr(mesh, "mesh") else mesh)
    per = _ranks_per_slice(ranks.size, devices_per_slice)
    report = {}
    for ax, name in enumerate(AXES):
        moved = np.moveaxis(ranks, ax, 0)
        cols = moved.reshape(moved.shape[0], -1) // per
        report[name] = "dcn" if bool((cols != cols[:1]).any()) else "ici"
    return report
