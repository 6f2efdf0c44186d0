"""The data-parallel training step of the port (counterpart of
``midd_tpu/parallel/train_dp.py``).

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

Meshes with sp > 1 or tp > 1 raise (ROADMAP.md queue 1 items 15b and 15c).
"""

from __future__ import annotations

import functools
from typing import Callable, List

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


def dp_group(mesh):
    """The process group of the mesh's dp axis, or None where there is no
    mesh or dp is 1 (this process holds the whole batch)."""
    if mesh is None:
        return None
    dp, _, _ = check_mesh_shape(mesh.mesh.shape)
    return mesh.get_group(AXES[0]) if dp > 1 else None


def sync_batch_stats(model: nn.Module, group) -> None:
    """Make every ``BatchNorm2d`` of ``model`` take its train-mode
    statistics over ``group``'s global batch (None: this process's batch)."""
    reduce = None if group is None else functools.partial(all_reduce_sum, group=group)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sum_over_ranks = reduce


def average_gradients(loss: torch.Tensor, params: List[nn.Parameter], group) -> torch.Tensor:
    """Replace each parameter's ``.grad`` by its mean over ``group`` and
    return the mean loss, in one ``all_reduce``; with no group, ``loss``.
    Every rank must hold gradients for the same parameters."""
    if group is None:
        return loss
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([loss.detach().reshape(1).float(), *(g.reshape(-1) for g in grads)])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 1
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[0]


def make_sharded_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, model: nn.Module,
                            mesh=None, grad_clip: float = 1.0) -> Callable:
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
    (``sync_batch_stats``)."""
    from midd_tpu_torch.train.trainer import finite_update  # the trainer imports this module

    group = dp_group(mesh)
    sync_batch_stats(model, group)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, draw, *args) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batch, draw, *args)
        loss.backward()
        loss = average_gradients(loss.detach(), params, group)
        finite_update(loss, params, optimizer, grad_clip)
        return loss

    return step
