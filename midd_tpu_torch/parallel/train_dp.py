"""The data-, tensor- and spatial-parallel training step of the port
(counterpart of ``midd_tpu/parallel/train_dp.py``, and of the JAX
trainer's step over a (dp, sp, tp) mesh).

The JAX package runs one program on a batch sharded over dp, and XLA
inserts the gradient psum. The port runs one process per rank, each with a
full replica of the model and its rows of the global batch, and reduces
across the mesh's dp group itself:

- the gradients and the loss travel in ONE ``all_reduce`` of a flat buffer,
  then are divided by dp. Every loss of the port is a mean over the batch's
  rows, and the ranks hold equal rows, so the mean of the ranks' losses and
  gradients is the global batch's. One reduction gives the skip decision
  (``finite_update`` on the global loss) and the update the same inputs on
  every rank: a non-finite loss on one rank is skipped on all. The clip
  and AdamW then run on identical gradients, so the replicas stay equal.
  (Not ``DistributedDataParallel``: its bucketed reduction overlaps the
  backward, but it carries neither the loss nor the skip decision, and its
  hooks would run again in a rematerialised forward.)
- ``BatchNorm2d`` takes its statistics over the global batch: the
  per-channel sums, sums of squares and counts are summed across the ranks
  by ``all_reduce_sum``, whose backward sums the gradients the same way, as
  XLA's partitioned reduction does.

At tp > 1 the model is split over the mesh's tp group
(``parallel/tp.py::shard_over_group``): the ranks of a tp group hold the
same rows, draw the same noise and compute the same loss, each with its
slices of the split parameters. The dp reduction above runs over the dp
group only (the ranks with the same tp coordinate hold the same slices).
The gradients of the parameters that every tp rank holds whole are then
averaged over the tp group, with the loss, in one more ``all_reduce``:
they are equal in exact arithmetic, but a backward kernel that sums with
atomics (the bilinear resize's on CUDA) leaves them a last bit apart, and
the replicas would drift. The clip takes the norm of the whole, unsharded
gradient, summing the slices' squares over the tp group
(``trainer.global_norm``).

At sp > 1 the model's convolutions are row-split over the mesh's sp group
(``parallel/sp.py::shard_rows_over_group``): the ranks of an sp group hold
the same rows of the batch and the same whole parameters, and compute the
same loss. Each rank's gradient of a row-split layer covers its block of
output rows only, so those gradients are summed over the sp group; the
others, equal in exact arithmetic, are averaged, with the loss, in the
same ``all_reduce``. The dp mean follows, and the clip takes the plain
norm of the result, which is the whole gradient's.

At sp > 1 and tp > 1 together the tp split comes first and the row split
wraps it (``parallel/sp.py``): the ranks of one (sp, tp) block hold the
same rows of the batch, and a rank holds its tp slice of each split
parameter, with a gradient over its block of rows where the layer is
row-split. The three reductions run in the same order: over sp, the
row-split parameters' gradients (slices and whole) are summed and the
others averaged, with the loss; over dp, everything is averaged; over tp,
the whole parameters' gradients are averaged, with the loss. The sp sum
leaves every sp rank with its tp slice's whole gradient, so the clip sums
the slices' squares over the tp group only (``trainer.global_norm``).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from midd_tpu_torch.models.blocks import BatchNorm2d
from midd_tpu_torch.parallel.mesh import AXES, check_mesh_shape


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient is summed the same way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def _axis_group(mesh, axis: str):
    if mesh is None:
        return None
    sizes = dict(zip(AXES, check_mesh_shape(mesh.mesh.shape)))
    return mesh.get_group(axis) if sizes[axis] > 1 else None


def dp_group(mesh):
    """The process group of the mesh's dp axis, or None where there is no
    mesh or dp is 1 (this process holds the whole batch)."""
    return _axis_group(mesh, "dp")


def tp_group(mesh):
    """The process group of the mesh's tp axis, or None where there is no
    mesh or tp is 1 (this process holds every parameter whole)."""
    return _axis_group(mesh, "tp")


def sp_group(mesh):
    """The process group of the mesh's sp axis, or None where there is no
    mesh or sp is 1 (this process computes every row)."""
    return _axis_group(mesh, "sp")


def sync_batch_stats(model: nn.Module, group) -> None:
    """Make every ``BatchNorm2d`` of ``model`` take its train-mode
    statistics over ``group``'s global batch (None: this process's batch)."""
    reduce = None if group is None else functools.partial(all_reduce_sum, group=group)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sum_over_ranks = reduce


def average_gradients(loss: torch.Tensor, params: List[nn.Parameter], group,
                      summed: Optional[List[bool]] = None) -> torch.Tensor:
    """Replace each parameter's ``.grad`` by its mean over ``group`` (its
    sum, where ``summed`` flags it) and return the mean loss, in one
    ``all_reduce``; with no group, ``loss``. Every rank must hold gradients
    for the same parameters."""
    if group is None:
        return loss
    held = [(p.grad, s) for p, s in zip(params, summed or [False] * len(params)) if p.grad is not None]
    flat = torch.cat([loss.detach().reshape(1).float(), *(g.reshape(-1) for g, _ in held)])
    dist.all_reduce(flat, group=group)
    n = dist.get_world_size(group)
    offset = 1
    for g, s in held:
        part = flat[offset : offset + g.numel()].view_as(g)
        g.copy_(part if s else part / n)
        offset += g.numel()
    return flat[0] / n


def make_sharded_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, model: nn.Module,
                            mesh=None, grad_clip: float = 1.0, shards=None) -> Callable:
    """``step(batch, draw, *args) -> loss``: one update of ``model`` from this
    rank's rows of the global batch, the same update on every rank of the
    mesh's dp group as the single-process step computes on the global batch.
    ``loss_fn(model, batch, draw, *args) -> (loss, parts)`` is the
    single-process loss on the rank's rows; ``draw`` its random draws for
    those rows. The returned loss is the global batch's (a 0-d tensor); a
    non-finite one leaves the parameters and the optimizer untouched on
    every rank. The trained parameters are those of ``model`` that require
    a gradient. ``mesh=None`` or dp 1: the single-process step. Sets
    ``model``'s BatchNorm statistics to the global batch's
    (``sync_batch_stats``). ``shards``: the ``RankShards`` of a ``model``
    split over the mesh's tp group, row-split over its sp group, or both,
    whose ``params()`` are the trained ones."""
    from midd_tpu_torch.train.trainer import finite_update  # the trainer imports this module

    group = dp_group(mesh)
    sync_batch_stats(model, group)
    if shards is None:
        params, sliced, summed = [p for p in model.parameters() if p.requires_grad], None, None
    else:
        params, sliced, summed = shards.params(), [d is not None for d in shards.param_dims()], shards.param_summed()
    tp, sp = tp_group(mesh), sp_group(mesh)
    whole = params if sliced is None else [p for p, s in zip(params, sliced) if not s]

    def step(batch, draw, *args) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batch, draw, *args)
        loss.backward()
        loss = average_gradients(loss.detach(), params, sp, summed)
        loss = average_gradients(loss, params, group)
        loss = average_gradients(loss, whole, tp)
        finite_update(loss, params, optimizer, grad_clip, sliced, tp)
        return loss

    return step
