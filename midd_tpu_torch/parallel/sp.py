"""Spatial parallelism: a convolution's output rows split over sp devices or
ranks (the port's counterpart of the JAX package's sp layout,
``midd_tpu/parallel/mesh.py::image_sharding``, which the JAX engine applies
to every jitted path, ``midd_tpu/serve/engine.py:937-943``, and the JAX
trainer to its batches, ``midd_tpu/train/trainer.py:326-344``).

The JAX package shards every activation by rows and lets GSPMD insert the
halo exchanges. The port splits only the convolutions, the way its tp
(``parallel/tp.py``) splits their output channels: each sp device or rank
computes a contiguous block of a layer's output rows (``row_blocks``) from
the whole input, and the blocks are gathered in row order. Activations stay
whole, so norms, attention, resizes, pooling, SCA, the time MLP's ``Linear``
layers, the losses and all elementwise work run once on whole tensors, and
the flash kernel launches as often as unsharded (GSPMD gathers the operands
of the opaque ``pallas_call`` too). This layout shows that the mode computes
the unsharded function; it saves neither memory nor latency (ROADMAP.md
queue 2 lists the row-sharded redesign).

Which input rows an output block reads (``RowGeometry``): a ``Conv2d`` of
kernel k, stride s and padding p (3×3 stride 1 and 2, 1×1, the NAFBlock's
depthwise 3×3, the NAFNet's 2×2 stride-2 downsampler, ``QuantConv2d``) pads
the whole input once with the layer's zeros, and block [o0, o1) reads padded
rows [o0·s, (o1−1)·s + k) with no H padding of its own; a
``ConvTranspose2d`` (k 4 s 2 p 1 in the UNet, k 2 s 2 in the expert and the
router) reads the input rows that reach the block and crops its output; the
diffusion UNet's fused up/down convolution (``models/unet_diffusion.py::
fused_updown``) is a 3×3 stride-1 convolution and says so through
``SplitLayer.map``'s ``rows``. A dynamic ``QuantConv2d`` block quantises
with the whole input's scale, as JAX's reduction over a sharded tensor
gives it; a static one keeps its calibrated scale (calibrate whole, then
split).

Two forms, as tp has:

- ``RowParallel``, in one process over a list of sp devices (the serving
  engine), repeats allowed: a copy of the layer on each sp device computes
  its block there, and the blocks are concatenated on the activation's
  device. A layer that the tp rule split first (a ``ColumnParallel``)
  computes its (row block, channel slice) pieces on the (sp, tp) grid of
  devices. Inference only.
- ``RankRowParallel``, over an sp process group, with gradients (the
  trainer): each rank computes its block with the layer's whole weights and
  the blocks are all-gathered in row order. The gather's backward keeps
  this rank's rows of the output gradient; a copy-in before the layer
  all-reduces dx over the group, since each block gives dx only on the input
  rows it read. Each rank's weight gradient covers only its rows, so the
  trainer sums those over sp (``parallel/train_dp.py``). Without gradients
  (validation) every rank computes the whole layer, as the JAX trainer's
  eval runs replicated.

At sp > 1 and tp > 1 together the tp split comes first and the row split
wraps it, in both forms: ``RowParallel`` over ``ColumnParallel`` in the
engine, ``RankRowParallel`` over ``RankColumnParallel`` in the trainer.
The other order, a channel split of a row-split layer, computes the same
function; this one is chosen because it keeps the tp split as it is: its
parameter names and slices, and the tp ``RankShards``, which
``shard_rows_over_group`` extends, so that a checkpoint still gathers and
slices over tp only. The ranks of a tp group read the same row block; each
computes its channel slice of the block, the slices are gathered over tp,
then the blocks over sp. The backward runs the same pieces in reverse: the
sp gather keeps this rank's rows, the tp gather its channels, the tp
copy-in sums the block's dx over tp and the sp copy-in the whole input's
over sp. A weight slice's gradient on a rank covers its rows only, and is
summed over sp as a whole weight's is. Without gradients every rank
computes every row of its channel slice, and the tp group still gathers
the slices.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from midd_tpu_torch.parallel.tp import ColumnParallel, RankColumnParallel, RankShards, SplitLayer, copy_in

LAYERS = (nn.Conv2d, nn.ConvTranspose2d)
WHOLE = "sca"  # the NAFBlock's squeeze-and-excite: a 1×1 convolution of a pooled 1×1 map
GRAD_MESSAGE = ("the engine's spatial-parallel layers (RowParallel) run with gradients off; "
                "train at sp > 1 through the process-group form, parallel.sp.shard_rows_over_group "
                "(TrainConfig.mesh_shape)")


def row_blocks(h_out: int, sp: int) -> List[Tuple[int, int]]:
    """[o0, o1) of each of ``sp`` contiguous blocks of ``h_out`` rows, the
    first ``h_out % sp`` one row longer (``torch.tensor_split``'s rule); a
    block is empty where ``h_out < sp``."""
    base, extra = divmod(h_out, sp)
    blocks, start = [], 0
    for i in range(sp):
        n = base + (i < extra)
        blocks.append((start, start + n))
        start += n
    return blocks


@dataclass(frozen=True)
class RowGeometry:
    """How a layer's output rows depend on its input rows along H: a
    convolution (``transposed`` False) or a transposed convolution of
    kernel ``k``, stride ``s`` and padding ``p``."""

    k: int
    s: int
    p: int
    transposed: bool = False

    @staticmethod
    def of(layer: nn.Module) -> "RowGeometry":
        if layer.dilation[0] != 1 or getattr(layer, "padding_mode", "zeros") != "zeros":
            raise ValueError(f"no row split for {layer}: dilation and non-zero padding modes are not supported")
        if isinstance(layer, nn.ConvTranspose2d) and layer.output_padding[0]:
            raise ValueError(f"no row split for {layer}: output_padding is not supported")
        return RowGeometry(layer.kernel_size[0], layer.stride[0], layer.padding[0],
                           isinstance(layer, nn.ConvTranspose2d))

    def out_rows(self, h: int) -> int:
        if self.transposed:
            return (h - 1) * self.s - 2 * self.p + self.k
        return (h + 2 * self.p - self.k) // self.s + 1

    def padded(self, x: torch.Tensor) -> torch.Tensor:
        """The whole input as the blocks read it: a convolution's padded
        once along H with zeros."""
        return x if self.transposed or not self.p else F.pad(x, (0, 0, self.p, self.p))

    def in_rows(self, o0: int, o1: int, h: int) -> Tuple[int, int]:
        """[a, b) of the rows of ``padded(x)`` that output rows [o0, o1)
        read (``h``: the unpadded input's rows)."""
        if self.transposed:
            a = max(0, -((self.k - 1 - o0 - self.p) // self.s))  # ceil((o0 + p - k + 1) / s)
            return a, min(h, (o1 - 1 + self.p) // self.s + 1)
        return o0 * self.s, (o1 - 1) * self.s + self.k

    def crop(self, y: torch.Tensor, o0: int, o1: int, a: int) -> torch.Tensor:
        """Output rows [o0, o1) of a block computed from rows [a, ...) with
        no H padding."""
        if not self.transposed:
            return y
        return y.narrow(2, o0 + self.p - a * self.s, o1 - o0)


def _convs(layer: nn.Module) -> List[nn.Module]:
    """The convolutions that compute ``layer``: a tp split layer's slices
    (``ColumnParallel``, ``RankColumnParallel``), else the layer."""
    if isinstance(layer, ColumnParallel):
        return list(layer.shards)
    return [layer.shard] if isinstance(layer, RankColumnParallel) else [layer]


def _base(layer: nn.Module) -> nn.Module:
    return _convs(layer)[0]


def _unpadded_rows(layer: nn.Module) -> nn.Module:
    """``layer`` with no padding along H, in place, its tp slices' where it
    is split (a block reads padded rows, or crops a transposed
    convolution's output)."""
    for conv in _convs(layer):
        conv.padding = (0, *tuple(conv.padding)[1:])
    return layer


def _apply(fn: Callable, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``fn(layer, x)``, or, for a tp split layer, ``fn`` of each slice,
    gathered."""
    return layer.map(fn, x) if isinstance(layer, SplitLayer) else fn(layer, x)


def _dynamic_int8(layer: nn.Module) -> bool:
    from midd_tpu_torch.ops.qconv import QuantConv2d

    return isinstance(layer, QuantConv2d) and layer.mode == "dynamic"


def _block_fn(fn: Callable, layer: nn.Module, x: torch.Tensor) -> Callable:
    """``fn`` as a block runs it: a dynamic int8 layer quantises every
    block with the whole input's abs-max."""
    if not _dynamic_int8(_base(layer)):
        return fn
    absmax = x.float().abs().amax()
    return lambda blk, xi: blk(xi, act_absmax=absmax.to(xi.device))


def _tp_row(entry) -> List[torch.device]:
    """One entry of a list of sp devices as the tp devices of its block: a
    device, or a sequence of them (a row of the (sp, tp) grid)."""
    if isinstance(entry, (str, torch.device)):
        return [torch.device(entry)]
    return [torch.device(d) for d in entry]


class RowParallel(SplitLayer):
    """``layer`` (or a ``ColumnParallel``) with its output rows split into
    ``len(devices)`` blocks, in one process: block i on ``devices[i]``, or,
    where ``devices[i]`` is a row of tp devices, slice j of block i on
    ``devices[i][j]``."""

    def __init__(self, layer: nn.Module, devices: Sequence):
        super().__init__()
        self.geometry = RowGeometry.of(_base(layer))
        self.blocks = nn.ModuleList(self._block_copy(layer, _tp_row(d)) for d in devices)

    @staticmethod
    def _block_copy(layer: nn.Module, devices: List[torch.device]) -> nn.Module:
        block = copy.deepcopy(layer)
        if isinstance(block, ColumnParallel):
            if len(devices) != len(block.shards):
                raise ValueError(f"{len(block.shards)} tp slices, {len(devices)} tp devices for a row block")
            block.devices = devices
            for j, d in enumerate(devices):
                block.shards[j] = _unpadded_rows(block.shards[j]).to(d)
            return block
        return _unpadded_rows(block).to(devices[0])

    def map(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor], x: torch.Tensor,
            rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        """``fn`` of each row block on its device, concatenated in row order
        on ``x``'s device. ``rows``: the (kernel, stride, padding) of ``fn``
        along H where it is not the layer's own forward."""
        if torch.is_grad_enabled():
            raise RuntimeError(GRAD_MESSAGE)
        geom = self.geometry if rows is None else RowGeometry(*rows)
        h = x.shape[2]
        xp = geom.padded(x)
        fn = _block_fn(fn, self.blocks[0], x)
        parts = []
        for (o0, o1), block in zip(row_blocks(geom.out_rows(h), len(self.blocks)), self.blocks):
            if o0 == o1:
                continue
            a, b = geom.in_rows(o0, o1, h)
            dev = block.devices[0] if isinstance(block, ColumnParallel) else block.weight.device
            y = _apply(fn, block, xp[:, :, a:b].to(dev))
            parts.append(geom.crop(y, o0, o1, a).to(x.device))
        return torch.cat(parts, dim=2)


def _row_split(module: nn.Module, make: Callable[[nn.Module], nn.Module]) -> List[str]:
    """Replace every spatial convolution of ``module`` (a tp split one
    included) by ``make(layer)``; returns their names. The convolution of a
    NAFBlock's SCA reads a pooled 1×1 map and stays whole."""
    if any(isinstance(m, (RowParallel, RankRowParallel)) for m in module.modules()):
        raise ValueError("module is already spatial-parallel")
    names: List[str] = []
    for name, layer in list(module.named_modules()):
        if any(name.startswith(n + ".") for n in names) or WHOLE in name.split("."):
            continue
        if not isinstance(_base(layer), LAYERS):
            continue  # not a convolution (a tp split Linear neither)
        if not name:
            raise ValueError("the sp split applies to the layers inside a module, not to a bare layer")
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent), child, make(layer))
        names.append(name)
    return names


def shard_rows(module: nn.Module, devices) -> int:
    """Split every convolution of ``module`` over the sp ``devices`` in
    place (``RowParallel``): a list of devices, or, for a module whose tp
    split (``shard_params``) came first, the (sp, tp) grid of them, whose
    first row holds the tp devices it was split over. Returns the number
    of split layers. The time MLP's ``Linear`` layers are not spatial and
    stay as they are."""
    return len(_row_split(module, lambda layer: RowParallel(layer, devices)))


# ---------------------------------------------------------------------------
# Across the ranks of a process group, with gradients
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' row blocks all-gathered along H, in rank order
    (each padded to the longest block for the collective, then cut back to
    ``sizes``). Backward: this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, sizes: List[int], group) -> torch.Tensor:
        rank = dist.get_rank(group)
        ctx.start, ctx.n = sum(sizes[:rank]), sizes[rank]
        longest = max(sizes)
        held = F.pad(y, (0, 0, 0, longest - y.shape[2])).contiguous()
        parts = [torch.empty_like(held) for _ in sizes]
        dist.all_gather(parts, held, group=group)
        return torch.cat([p.narrow(2, 0, n) for p, n in zip(parts, sizes)], dim=2)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(2, ctx.start, ctx.n).contiguous(), None, None


class RankRowParallel(SplitLayer):
    """``layer``, whole or this rank's tp slice of it (a
    ``RankColumnParallel``), computing this rank's block of output rows of
    ``group``; the forward all-gathers the blocks. Every rank of the group
    must run it. The layer's parameters stay trainable; their gradient on
    a rank covers its rows only. A forward without gradients (the
    trainer's validation) computes every row on every rank and gathers
    nothing over sp, as the JAX trainer's jitted eval, whose input is not
    image-sharded, runs replicated over sp."""

    def __init__(self, layer: nn.Module, group):
        super().__init__()
        self.geometry = RowGeometry.of(_base(layer))
        self.group = group
        self.layer = _unpadded_rows(layer)

    def map(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor], x: torch.Tensor,
            rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        geom = self.geometry if rows is None else RowGeometry(*rows)
        h = x.shape[2]
        h_out = geom.out_rows(h)
        run = _block_fn(fn, self.layer, x)
        if not torch.is_grad_enabled():
            a, b = geom.in_rows(0, h_out, h)
            return geom.crop(_apply(run, self.layer, geom.padded(x)[:, :, a:b]), 0, h_out, a)
        sp, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        x = copy_in(x, self.group)
        blocks = row_blocks(h_out, sp)
        o0, o1 = blocks[rank]
        if o0 == o1:  # an empty block: one row computed and none kept, so every parameter gets a gradient
            o0 = min(o0, h_out - 1)
            o1 = o0 + 1
        a, b = geom.in_rows(o0, o1, h)
        y = geom.crop(_apply(run, self.layer, geom.padded(x)[:, :, a:b]), o0, o1, a)
        y = y.narrow(2, 0, blocks[rank][1] - blocks[rank][0])
        return _GatherRows.apply(y, [hi - lo for lo, hi in blocks], self.group)


def shard_rows_over_group(module: nn.Module, group, shards: Optional[RankShards] = None) -> RankShards:
    """Split every convolution of ``module`` in place over the ranks of
    ``group`` (``RankRowParallel``). Every rank must hold the same weights
    when it is called. Returns the ``RankShards`` that maps the split
    module back to the unsharded one, with the row-split layers'
    parameters in ``summed``, whose gradients the trainer sums over the
    group. ``shards``: the ``RankShards`` of a tp split of ``module``
    (``parallel.tp.shard_over_group``) made first; it is extended in place
    (its keys followed into the row-split layers, its tp ``dims``, group
    and count kept) and returned. Without it every parameter is whole."""
    if shards is None:
        names = list(module.state_dict())
        shards = RankShards(module, group, names, [n for n, p in module.named_parameters() if p.requires_grad],
                            {n: n for n in names}, {n: None for n in names}, 0)
    summed = set()
    for name in _row_split(module, lambda layer: RankRowParallel(layer, group)):
        for key, held in list(shards.local.items()):
            if held.startswith(name + "."):
                shards.local[key] = f"{name}.layer.{held[len(name) + 1:]}"
                summed.add(key)
    shards.summed = [n for n in shards.param_names if n in summed]
    return shards
