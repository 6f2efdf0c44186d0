"""Tensor parallelism: a layer's output channels split over tp devices or
ranks (the port's counterpart of the JAX package's tp layout,
``midd_tpu/parallel/mesh.py::param_shardings``, which the JAX engine
applies with ``midd_tpu/serve/engine.py::_shard`` and the JAX trainer by
``jax.device_put`` at ``midd_tpu/train/trainer.py:314-347``).

Two forms of the same column split, by ``mesh.param_shardings``'s rule:

- In one process, over a list of local devices (the serving engine):
  ``shard_params`` makes every ``Conv2d`` (the depthwise ones included),
  ``Linear`` and ``ConvTranspose2d`` whose weight the rule splits a
  ``ColumnParallel``, which holds one slice of the layer's output channels
  (weight and bias) on each tp device, computes each slice there and
  gathers the slices, in channel order, onto the activation's device. A
  split per-channel parameter that is no layer's (NAFBlock's ``beta`` and
  ``gamma``, split by the rule only when ``min_size`` is below their
  channel count) is held as slices on the tp devices too and gathered where
  it is read. Everything else (norms, attention, elementwise work) runs
  once, on the full activation, on its device. Inference only: a
  ``ColumnParallel`` raises when gradients are on.
- Across the ranks of a process group, with gradients (the trainer at
  tp > 1): ``shard_over_group`` makes each such layer a
  ``RankColumnParallel``, which holds only this rank's slice, as trainable
  parameters. Each rank computes its slice from the full, replicated input
  and the slices are all-gathered in channel order; everything else runs
  replicated on every rank of the group. Two autograd pieces carry the
  gradients: the gather's backward keeps this rank's slice of the output
  gradient (identical on every rank, since all that follows is
  replicated), and the copy-in before the layer all-reduces the input
  gradient over the group, because each slice gives only its part of dx
  (a depthwise slice reads only its groups' channels, so its dx is zero
  elsewhere before the sum). Without the copy-in every layer upstream of a
  split one would train on a fraction of its gradient. ``RankShards``, what
  ``shard_over_group`` returns, maps the split module back to the unsharded
  one: its parameters in the unsharded order, and its state and AdamW's
  gathered into (or sliced from) the single-process layout, so that a
  checkpoint reads the same at any (dp, sp, tp). At sp > 1 the row split
  of ``parallel/sp.py`` wraps these layers and extends the same
  ``RankShards``.

The collectives are ``dist.all_reduce`` and the list form of
``dist.all_gather``, which gloo (the CPU, and ranks that share a card) and
NCCL both run on the tensors of their devices.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import parametrize

from midd_tpu_torch.parallel.mesh import count_tp_sharded, param_shardings

LAYERS = (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)
GRAD_MESSAGE = ("the engine's tensor-parallel layers (ColumnParallel) run with gradients off; "
                "train at tp > 1 through the process-group form, parallel.tp.shard_over_group "
                "(TrainConfig.mesh_shape)")


def gather_shards(parts: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The tp gather: the slices in device order, concatenated along the
    channel axis ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _slice_layer(layer: nn.Module, dim: int, lo: int, hi: int, device, trainable: bool = False) -> nn.Module:
    """A copy of ``layer`` on ``device`` that computes its output channels
    [lo, hi) (weight dim ``dim``); a grouped convolution's copy holds the
    groups of those channels. Buffers (a ``QuantConv2d``'s calibrated
    ``act_absmax``) go to ``device`` too; the copy keeps every other
    attribute (its int8 ``mode``)."""
    shard = copy.deepcopy(layer)
    w = layer.weight.detach().narrow(dim, lo, hi - lo)
    shard.weight = nn.Parameter(w.to(device, copy=True).contiguous(), requires_grad=trainable)
    if layer.bias is not None:
        shard.bias = nn.Parameter(layer.bias.detach()[lo:hi].to(device, copy=True), requires_grad=trainable)
    for name, buf in shard.named_buffers(recurse=False):
        setattr(shard, name, buf.to(device))
    if isinstance(layer, nn.Linear):
        shard.out_features = hi - lo
    else:
        shard.out_channels = hi - lo
        if layer.groups > 1:
            shard.groups = (hi - lo) // (layer.out_channels // layer.groups)
            shard.in_channels = shard.groups * (layer.in_channels // layer.groups)
    return shard


def _split_geometry(layer: nn.Module, tp: int):
    """(weight dim of the output channels, channels a slice, the input
    channels slice i reads: None for all, else (start, length) of its
    groups'), checking that the layer splits into ``tp`` whole-group
    slices."""
    transposed = isinstance(layer, nn.ConvTranspose2d)
    dim = 1 if transposed else 0
    out = layer.weight.shape[dim]
    if out % tp:
        raise ValueError(f"{out} output channels do not split over tp={tp}")
    per = out // tp
    groups = getattr(layer, "groups", 1)
    per_group = out // groups
    if groups > 1 and (transposed or per % per_group):
        raise ValueError(f"a slice of {per} output channels does not hold whole groups of {per_group}")
    in_group = layer.in_channels // groups if groups > 1 else 0

    def cut(i: int):
        return (i * per // per_group * in_group, per // per_group * in_group) if groups > 1 else None

    return dim, per, cut


class SplitLayer(nn.Module):
    """A layer computed in pieces and gathered: its output channels in
    slices here, its output rows in blocks in ``parallel/sp.py``.
    ``forward`` is ``map`` of the layer's own forward, and
    ``models/unet_diffusion.fused_updown`` maps its fused convolution so,
    naming that convolution's (kernel, stride, padding) along H in ``rows``
    (which a row split reads and a channel split ignores)."""

    # the activation's channel axis: NCHW's 1, a Linear's last
    channel_dim: int = 1

    def map(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor], x: torch.Tensor,
            rows: Optional[tuple] = None) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.map(lambda layer, xi: layer(xi), x)


class ColumnParallel(SplitLayer):
    """``layer`` with its output channels split into ``len(devices)`` equal
    slices, slice i on ``devices[i]``, in one process. A grouped
    convolution's slice reads only its groups' input channels, so each slice
    must hold whole groups (a depthwise convolution's always does)."""

    def __init__(self, layer: nn.Module, devices: Sequence):
        super().__init__()
        dim, per, cut = _split_geometry(layer, len(devices))
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.channel_dim = -1 if isinstance(layer, nn.Linear) else 1
        self.in_slices = [cut(i) for i in range(len(devices))]
        self.shards = nn.ModuleList(
            _slice_layer(layer, dim, i * per, (i + 1) * per, d) for i, d in enumerate(self.devices)
        )

    def map(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor], x: torch.Tensor,
            rows: Optional[tuple] = None) -> torch.Tensor:
        """``fn(shard, x)`` for each slice on its device, gathered onto
        ``x``'s device."""
        if torch.is_grad_enabled():
            raise RuntimeError(GRAD_MESSAGE)
        parts = []
        for shard, device, cut in zip(self.shards, self.devices, self.in_slices):
            xi = x if cut is None else x.narrow(1, *cut)
            parts.append(fn(shard, xi.to(device)))
        return gather_shards(parts, self.channel_dim, x.device)


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


def _per_channel_names(module: nn.Module, rule: Dict[str, Optional[int]]) -> List[str]:
    """The split parameters of ``rule`` that belong to no layer of LAYERS."""
    layer_params = {f"{n}.{p}" if n else p for n, m in module.named_modules() if isinstance(m, LAYERS)
                    for p in ("weight", "bias")}
    return [name for name, dim in rule.items() if dim is not None and name not in layer_params]


def _split_layers(module: nn.Module, rule: Dict[str, Optional[int]], make: Callable[[nn.Module], nn.Module]) -> List[str]:
    """Replace each layer whose weight ``rule`` splits by ``make(layer)``;
    returns their names."""
    if any(isinstance(m, SplitLayer) for m in module.modules()):
        raise ValueError("module is already tensor-parallel")
    names = []
    for name, layer in list(module.named_modules()):
        if isinstance(layer, LAYERS) and rule.get(f"{name}.weight" if name else "weight") is not None:
            if not name:
                raise ValueError("the tp split applies to the layers inside a module, not to a bare layer")
            parent, _, child = name.rpartition(".")
            setattr(module.get_submodule(parent), child, make(layer))
            names.append(name)
    return names


def shard_params(module: nn.Module, devices: Sequence, min_size: int = 1 << 16) -> int:
    """Split ``module``'s parameters over the tp ``devices`` in place, by
    ``param_shardings``'s rule at tp = ``len(devices)``; the first device
    must be the one ``module`` is on. Returns the number of split
    parameters (``count_tp_sharded``). Call it once a module, after loading
    and casting its weights (and calibrating its int8 scales)."""
    rule = param_shardings(module, len(devices), min_size)
    per_channel = _per_channel_names(module, rule)
    _split_layers(module, rule, lambda layer: ColumnParallel(layer, devices))
    for name in per_channel:
        owner, _, pname = name.rpartition(".")
        parametrize.register_parametrization(module.get_submodule(owner), pname,
                                             _GatheredParameter(rule[name], devices))
    return count_tp_sharded(rule)


# ---------------------------------------------------------------------------
# Across the ranks of a process group, with gradients
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)]


class _Gather(torch.autograd.Function):
    """Forward: the ranks' slices all-gathered along ``dim``, in rank order.
    Backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _own_slice(grad, ctx.dim, ctx.group).contiguous(), None, None


class _CopyIn(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the group
    (each rank's slice contributed its part of it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_over_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable all-gather of the ranks' slices along ``dim``."""
    return _Gather.apply(x, dim, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the input of a split layer: its gradient is summed over
    ``group``."""
    return _CopyIn.apply(x, group)


class RankColumnParallel(SplitLayer):
    """``layer``'s slice of output channels for this rank of ``group``
    (weight and bias as trainable parameters, on the layer's device); the
    forward computes the slice from the full input and all-gathers the
    ranks' slices. Every rank of the group must run it."""

    def __init__(self, layer: nn.Module, group):
        super().__init__()
        tp, rank = dist.get_world_size(group), dist.get_rank(group)
        dim, per, cut = _split_geometry(layer, tp)
        self.group = group
        self.channel_dim = -1 if isinstance(layer, nn.Linear) else 1
        self.in_slice = cut(rank)
        self.shard = _slice_layer(layer, dim, rank * per, (rank + 1) * per, layer.weight.device,
                                  trainable=layer.weight.requires_grad)

    def map(self, fn: Callable[[nn.Module, torch.Tensor], torch.Tensor], x: torch.Tensor,
            rows: Optional[tuple] = None) -> torch.Tensor:
        x = copy_in(x, self.group)
        xi = x if self.in_slice is None else x.narrow(1, *self.in_slice)
        return gather_over_group(fn(self.shard, xi), self.channel_dim, self.group)


class _RankGatheredParameter(nn.Module):
    """A parametrization that holds this rank's slice of a parameter along
    ``dim`` and all-gathers the slices where the parameter is read."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return _own_slice(full.detach(), self.dim, self.group).clone().contiguous()

    def forward(self, part: torch.Tensor) -> torch.Tensor:
        return gather_over_group(part, self.dim, self.group)


@dataclass
class RankShards:
    """A module split over a tp process group by ``shard_over_group``,
    row-split over an sp group by ``parallel.sp.shard_rows_over_group``, or
    both (the tp split first), and the map back to the unsharded module.
    ``group``: the tp group, over which the slices are gathered and cut
    (the sp group where there is no tp split: every key is whole then).
    ``names``: the unsharded ``state_dict``'s keys in order;
    ``param_names``: its trainable parameters in ``parameters()`` order (a
    single-process optimizer's indices); ``local``: each key's name in the
    split module, through both wrappers; ``dims``: the dim along which this
    rank holds a tp slice of each key (None: whole). ``n_sharded``: the tp
    rule's ``count_tp_sharded``. ``summed``: the parameters whose gradient
    each rank computes for its block of output rows only, to be summed
    over the sp group (the row-split layers'; none under tp alone)."""

    module: nn.Module
    group: Any
    names: List[str]
    param_names: List[str]
    local: Dict[str, str]
    dims: Dict[str, Optional[int]]
    n_sharded: int
    summed: List[str] = field(default_factory=list)

    def params(self) -> List[nn.Parameter]:
        """This rank's trainable parameters, in the unsharded module's order."""
        held = self.module.state_dict(keep_vars=True)
        return [held[self.local[n]] for n in self.param_names]

    def param_dims(self) -> List[Optional[int]]:
        """``dims`` of each of ``params()``."""
        return [self.dims[n] for n in self.param_names]

    def param_summed(self) -> List[bool]:
        """Whether each of ``params()`` is in ``summed``."""
        return [n in self.summed for n in self.param_names]

    def _gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return t if dim is None else _all_gather(t, dim, self.group)

    def _slice(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return t if dim is None else _own_slice(t, dim, self.group).clone()

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The unsharded module's ``state_dict`` (every rank of the group
        must call it)."""
        held = self.module.state_dict()
        with torch.no_grad():
            return {n: self._gather(held[self.local[n]], self.dims[n]) for n in self.names}

    def load_full_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load an unsharded ``state_dict`` (strict): each tensor's slice
        where this rank holds one."""
        if set(state) != set(self.names):
            missing, extra = set(self.names) - set(state), set(state) - set(self.names)
            raise KeyError(f"state_dict does not match the module: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        held = self.module.state_dict(keep_vars=True)
        with torch.no_grad():
            for n in self.names:
                held[self.local[n]].copy_(self._slice(state[n], self.dims[n]))

    def _optimizer_state(self, opt_state: Dict, fn) -> Dict:
        state = {}
        for i in sorted(opt_state["state"]):
            dim = self.dims[self.param_names[i]]
            state[i] = {k: fn(v, dim) if torch.is_tensor(v) and v.ndim > 0 else v
                        for k, v in opt_state["state"][i].items()}
        return {"state": state, "param_groups": opt_state["param_groups"]}

    def full_optimizer_state(self, opt_state: Dict) -> Dict:
        """An optimizer ``state_dict`` over ``params()`` in the single-process
        layout: each per-parameter tensor (AdamW's moments) gathered (every
        rank of the group must call it)."""
        return self._optimizer_state(opt_state, self._gather)

    def sliced_optimizer_state(self, opt_state: Dict) -> Dict:
        """A single-process optimizer ``state_dict`` cut to ``params()``."""
        return self._optimizer_state(opt_state, self._slice)


def shard_over_group(module: nn.Module, group, min_size: int = 1 << 16) -> RankShards:
    """Split ``module`` in place over the ranks of ``group`` by
    ``param_shardings``'s rule at tp = the group's size: this rank keeps its
    slice of each split layer (``RankColumnParallel``) and of each split
    per-channel parameter (gathered where it is read). Every rank must hold
    the same full weights when it is called. Returns the ``RankShards``."""
    tp = dist.get_world_size(group)
    rule = param_shardings(module, tp, min_size)
    names = list(module.state_dict())
    param_names = [n for n, p in module.named_parameters() if p.requires_grad]
    local = {n: n for n in names}
    dims: Dict[str, Optional[int]] = {n: None for n in names}
    per_channel = _per_channel_names(module, rule)
    for name in _split_layers(module, rule, lambda layer: RankColumnParallel(layer, group)):
        for leaf in ("weight", "bias"):
            key = f"{name}.{leaf}"
            if key in local:
                local[key] = f"{name}.shard.{leaf}"
                dims[key] = rule[f"{name}.weight"] if leaf == "weight" else 0
    for name in per_channel:
        owner, _, pname = name.rpartition(".")
        parametrize.register_parametrization(module.get_submodule(owner), pname,
                                             _RankGatheredParameter(rule[name], group))
        local[name] = f"{owner + '.' if owner else ''}parametrizations.{pname}.original"
        dims[name] = rule[name]
    return RankShards(module, group, names, param_names, local, dims, count_tp_sharded(rule))
