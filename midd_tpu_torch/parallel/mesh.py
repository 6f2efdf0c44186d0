"""The (dp, sp, tp) mesh of the port (counterpart of ``midd_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
XLA insert the collectives. The port's trainer runs one process per rank
under ``torch.distributed``: the same layout rule, applied to rank ids,
gives a ``DeviceMesh`` with dims named ("dp", "sp", "tp"), and the training
step issues its collectives itself (``parallel/train_dp.py``). The serving
engine lays out a list of local devices by the same rule, in one process.

Axes, as in the JAX package: dp shards the batch; sp the image rows; tp the
convolutions' output channels. Mesh policy: tp is the largest of (4, 2, 1)
dividing the device count (over sp) when it is not given; dp gets the rest.

dp: the batch rows that one dp rank holds are ``batch_sharding``'s,
replicated over sp and tp. tp: the layout rule (``param_shardings``,
``count_tp_sharded``), which ``parallel/tp.py`` applies: over local devices
in the engine, over the mesh's tp group in the trainer. sp: a rank's batch
rows and its index along sp (``image_sharding``); ``parallel/sp.py`` splits
the convolutions' output rows over the engine's sp devices or the
trainer's sp group. Both compose, in the engine and in the trainer: a
layer split on its channels is then row-split too. The ranks of one (sp,
tp) block of the trainer's mesh share a dp coordinate, so they hold the
same batch rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

AXES = ("dp", "sp", "tp")


def mesh_layout(n_devices: Optional[int] = None, tp: Optional[int] = None, sp: int = 1,
                ranks: Optional[Sequence] = None) -> np.ndarray:
    """``make_mesh``'s layout rule: the (dp, sp, tp) array of the first
    ``n_devices`` of ``ranks``, rank ids or devices (default: every rank of
    the process group, or one), with tp the largest of (4, 2, 1) dividing
    ``n // sp`` where it is None."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    n = n_devices or len(ranks)
    ranks = ranks[:n]
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if (n // sp) % cand == 0:
                tp = cand
                break
    dp = n // (sp * tp)
    layout = np.empty(n, dtype=object if any(not isinstance(r, int) for r in ranks) else np.int64)
    layout[:] = ranks
    return layout.reshape(dp, sp, tp)


def device_mesh(layout: np.ndarray, device_type: str):
    """A ``DeviceMesh`` over an initialised process group from a (dp, sp,
    tp) rank array; every rank of the group must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, layout.tolist(), mesh_dim_names=AXES)


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None, sp: int = 1,
              ranks: Optional[Sequence[int]] = None, device_type: str = "cuda"):
    """The (dp, sp, tp) ``DeviceMesh`` of ``mesh_layout``'s rule."""
    return device_mesh(mesh_layout(n_devices, tp, sp, ranks), device_type)


def batch_sharding(global_batch: int, mesh) -> Tuple[int, int]:
    """(start_row, n_rows) of the global batch that the calling rank holds:
    the batch is split over dp in rank order and replicated over sp and tp,
    the rule of the JAX package's ``P("dp")``."""
    dp = mesh.size(AXES.index("dp"))
    return process_rows(global_batch, dp, mesh.get_local_rank("dp"))


def replicated(tensors: Sequence, mesh) -> Sequence:
    """Give every rank the values of ``tensors`` that the mesh's first rank
    holds (a broadcast in place over the process group, which the mesh
    spans), as a replicated layout holds one full copy on every device.
    Returns ``tensors``."""
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src)
    return tensors


def process_rows(global_batch: int, n: int, index: int) -> Tuple[int, int]:
    """(start_row, n_rows) of part ``index`` of ``n`` equal parts."""
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    return index * per, per


def image_sharding(global_batch: int, mesh) -> Tuple[int, int, int, int]:
    """The JAX package's ``P("dp", "sp")`` for the calling rank: (start_row,
    n_rows) of the global batch over dp (``batch_sharding``), and the
    rank's index along sp and the sp size, by which ``parallel/sp.py``
    picks the image rows it computes."""
    start, n = batch_sharding(global_batch, mesh)
    return start, n, mesh.get_local_rank("sp"), mesh.size(AXES.index("sp"))


def _channel_dim(owner: nn.Module, name: str) -> int:
    """The dim of a parameter that holds its output channels, the last axis
    of its JAX leaf: 0 of a ``Conv2d`` (O, I/g, kh, kw) or ``Linear`` (out,
    in) weight, 1 of a ``ConvTranspose2d`` weight (I, O, kh, kw; the JAX
    ``kernel_t`` is HWIO) and of a per-channel (1, C, 1, 1) parameter such
    as NAFBlock's ``beta`` (JAX's (1, 1, 1, C))."""
    if name == "weight" and isinstance(owner, (nn.Conv2d, nn.Linear)):
        return 0
    return 1


def param_shardings(module: nn.Module, tp: int, min_size: int = 1 << 16) -> Dict[str, Optional[int]]:
    """The JAX package's tensor-parallel rule on ``module``'s parameters:
    for each parameter name, the dim it is split on over tp, or None
    (replicated). A parameter of at least 2 dims and ``min_size`` elements
    is split on its output channels where their count divides by tp;
    1-D parameters (biases, norm scales) never are."""
    out: Dict[str, Optional[int]] = {}
    for mname, owner in module.named_modules():
        for pname, p in owner.named_parameters(recurse=False):
            dim = _channel_dim(owner, pname)
            split = tp > 1 and p.ndim >= 2 and p.numel() >= min_size and p.shape[dim] % tp == 0
            out[f"{mname}.{pname}" if mname else pname] = dim if split else None
    return out


def count_tp_sharded(shardings: Dict[str, Optional[int]]) -> int:
    """Number of parameters that ``param_shardings`` splits over tp."""
    return sum(dim is not None for dim in shardings.values())


def check_mesh_shape(mesh_shape: Sequence[int]) -> Tuple[int, int, int]:
    """(dp, sp, tp) of a mesh shape, as ints; an axis under 1 raises."""
    dp, sp, tp = (int(x) for x in mesh_shape)
    if min(dp, sp, tp) < 1:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)}: every axis needs at least 1 device")
    return dp, sp, tp
