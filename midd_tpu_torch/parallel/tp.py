"""Tensor parallelism in one process: a layer's output channels split over
devices (the port's counterpart of the JAX engine's tp layout,
``midd_tpu/parallel/mesh.py::param_shardings`` applied by
``midd_tpu/serve/engine.py::_shard``).

``shard_params`` applies ``mesh.param_shardings``'s rule to a module in
place: every ``Conv2d`` (the depthwise ones included), ``Linear`` and
``ConvTranspose2d`` whose weight the rule splits becomes a
``ColumnParallel``, which holds one slice of the layer's output channels
(weight and bias) on each tp device, computes each slice there and gathers
the slices, in channel order, onto the activation's device. A split
per-channel parameter that is no layer's (NAFBlock's ``beta`` and
``gamma``, split by the rule only when ``min_size`` is below their channel
count) is held as slices on the tp devices too and gathered where it is
read. Everything else (norms, attention, elementwise work) runs once, on
the full activation, on its device.

Inference only: a ``ColumnParallel`` raises when gradients are on. Training
at tp > 1 (a process-group all-gather whose backward keeps the rank's
slice, in place of ``gather_shards``) is ROADMAP.md queue 1 item 15b part 2.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Sequence

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from midd_tpu_torch.parallel.mesh import count_tp_sharded, param_shardings

LAYERS = (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)


def gather_shards(parts: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The tp gather: the slices in device order, concatenated along the
    channel axis ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _slice_layer(layer: nn.Module, dim: int, lo: int, hi: int, device) -> nn.Module:
    """A copy of ``layer`` on ``device`` that computes its output channels
    [lo, hi) (weight dim ``dim``); a grouped convolution's copy holds the
    groups of those channels."""
    shard = copy.deepcopy(layer)
    w = layer.weight.detach().narrow(dim, lo, hi - lo)
    shard.weight = nn.Parameter(w.to(device, copy=True).contiguous(), requires_grad=False)
    if layer.bias is not None:
        shard.bias = nn.Parameter(layer.bias.detach()[lo:hi].to(device, copy=True), requires_grad=False)
    if isinstance(layer, nn.Linear):
        shard.out_features = hi - lo
    else:
        shard.out_channels = hi - lo
        if layer.groups > 1:
            shard.groups = (hi - lo) // (layer.out_channels // layer.groups)
            shard.in_channels = shard.groups * (layer.in_channels // layer.groups)
    return shard


class ColumnParallel(nn.Module):
    """``layer`` with its output channels split into ``len(devices)`` equal
    slices, slice i on ``devices[i]``. A grouped convolution's slice reads
    only its groups' input channels, so each slice must hold whole groups
    (a depthwise convolution's always does)."""

    def __init__(self, layer: nn.Module, devices: Sequence):
        super().__init__()
        transposed = isinstance(layer, nn.ConvTranspose2d)
        dim = 1 if transposed else 0
        out = layer.weight.shape[dim]
        tp = len(devices)
        if out % tp:
            raise ValueError(f"{out} output channels do not split over tp={tp}")
        per = out // tp
        groups = getattr(layer, "groups", 1)
        per_group = out // groups
        if groups > 1 and (transposed or per % per_group):
            raise ValueError(f"a slice of {per} output channels does not hold whole groups of {per_group}")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        # the activation's channel axis: NCHW's 1, a Linear's last
        self.channel_dim = -1 if isinstance(layer, nn.Linear) else 1
        # the input channels each slice reads: all, or its groups'
        in_group = layer.in_channels // groups if groups > 1 else 0
        self.in_slices = [(i * per // per_group * in_group, per // per_group * in_group) if groups > 1 else None
                          for i in range(tp)]
        self.shards = nn.ModuleList(
            _slice_layer(layer, dim, i * per, (i + 1) * per, d) for i, d in enumerate(self.devices)
        )

    def map(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """``fn(shard, x)`` for each slice on its device, gathered onto
        ``x``'s device: ``forward`` is ``map`` of the layer's own forward,
        and ``models/unet_diffusion.fused_updown`` maps its fused
        convolution so."""
        if torch.is_grad_enabled():
            raise RuntimeError(
                "tensor-parallel layers run with gradients off (inference); training at tp > 1 "
                "is ROADMAP.md queue 1 item 15b part 2"
            )
        parts = []
        for shard, device, cut in zip(self.shards, self.devices, self.in_slices):
            xi = x if cut is None else x.narrow(1, *cut)
            parts.append(fn(shard, xi.to(device)))
        return gather_shards(parts, self.channel_dim, x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.map(lambda layer, xi: layer(xi), x)


class _GatheredParameter(nn.Module):
    """A parametrization that holds a parameter as slices of ``dim`` on
    ``devices`` and gathers them, where the parameter is read, onto the
    first device."""

    def __init__(self, dim: int, devices: Sequence):
        super().__init__()
        self.dim = dim
        self.devices = [torch.device(d) for d in devices]

    def right_inverse(self, full: torch.Tensor):
        parts = full.detach().chunk(len(self.devices), dim=self.dim)
        return tuple(p.to(d, copy=True).contiguous() for p, d in zip(parts, self.devices))

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        return gather_shards(parts, self.dim, self.devices[0])


def shard_params(module: nn.Module, devices: Sequence, min_size: int = 1 << 16) -> int:
    """Split ``module``'s parameters over the tp ``devices`` in place, by
    ``param_shardings``'s rule at tp = ``len(devices)``; the first device
    must be the one ``module`` is on. Returns the number of split
    parameters (``count_tp_sharded``). Call it once a module, after loading
    and casting its weights."""
    if any(isinstance(m, ColumnParallel) for m in module.modules()):
        raise ValueError("module is already tensor-parallel")
    rule = param_shardings(module, len(devices), min_size)
    layer_params = {f"{n}.{p}" if n else p for n, m in module.named_modules() if isinstance(m, LAYERS)
                    for p in ("weight", "bias")}
    for name, layer in list(module.named_modules()):
        if isinstance(layer, LAYERS) and rule.get(f"{name}.weight" if name else "weight") is not None:
            if not name:
                raise ValueError("shard_params splits the layers inside a module, not a bare layer")
            parent, _, child = name.rpartition(".")
            setattr(module.get_submodule(parent), child, ColumnParallel(layer, devices))
    for name, dim in rule.items():
        if dim is not None and name not in layer_params:
            owner, _, pname = name.rpartition(".")
            parametrize.register_parametrization(module.get_submodule(owner), pname,
                                                 _GatheredParameter(dim, devices))
    return count_tp_sharded(rule)
