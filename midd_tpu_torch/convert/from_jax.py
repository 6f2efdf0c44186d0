"""JAX variables tree -> the port's ``state_dict``.

The exact inverse of ``midd_tpu/convert/torch_import.py::convert_state_dict``.
A flax module path becomes a torch key by splitting every trailing
``_<digits>`` of a component into a dotted index (``downs_0`` -> ``downs.0``,
``encoders_0_1`` -> ``encoders.0.1``, ``time_mlp_1`` -> ``time_mlp.1``).
Leaves:

- conv ``kernel`` (kH, kW, I/g, O) -> ``weight`` (O, I/g, kH, kW)
- ``kernel_t`` (kH, kW, I, O), stored flipped -> un-flip -> ``weight`` (I, O, kH, kW)
- Dense ``kernel`` (I, O) -> ``weight`` (O, I)
- norm ``scale`` -> ``weight``; ``bias`` -> ``bias``
- NAFBlock ``beta``/``gamma`` (1, 1, 1, C) -> (1, C, 1, 1)
- batch_stats ``mean``/``var`` -> ``running_mean``/``running_var``, plus a
  zero ``num_batches_tracked``

``qscales_from_jax`` maps the JAX ``qscales`` collection (each int8 conv's
calibrated ``act_absmax``) onto the port's module names, for
``ops.qconv.load_qscales``.

It takes numpy arrays (or anything ``np.asarray`` accepts) and imports no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_TRAILING_INDEX = re.compile(r"^(.*?)((?:_\d+)+)$")


def _torch_path(component: str) -> str:
    m = _TRAILING_INDEX.match(component)
    if not m or not m.group(1):
        return component
    return ".".join([m.group(1)] + m.group(2).split("_")[1:])


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _key(path: Tuple[str, ...], leaf: str) -> str:
    return ".".join([_torch_path(p) for p in path] + [leaf])


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., ["batch_stats": ...]}`` -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("params", {})):
        arr = np.asarray(value)
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            name = "weight"
        elif leaf == "kernel_t":
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("beta", "gamma") and arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
            name = leaf
        else:
            name = leaf
        out[_key(mod, name)] = torch.tensor(np.ascontiguousarray(arr))
    bn_modules = set()
    for path, value in _leaves(variables.get("batch_stats", {})):
        mod, leaf = path[:-1], path[-1]
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[_key(mod, name)] = torch.tensor(np.ascontiguousarray(value))
        bn_modules.add(mod)
    for mod in bn_modules:
        out[_key(mod, "num_batches_tracked")] = torch.tensor(0, dtype=torch.int64)
    return out


def qscales_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``qscales`` collection (``{"downs_0": {"block1_2":
    {"act_absmax": x}}, ...}``, with or without the outer ``"qscales"``
    key) -> ``{"downs.0.block1.2": tensor(x), ...}``."""
    tree = tree.get("qscales", tree)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        if path[-1] != "act_absmax":
            raise KeyError(f"unexpected qscales leaf {'/'.join(path)}")
        out[".".join(_torch_path(p) for p in path[:-1])] = torch.tensor(
            np.asarray(value, dtype=np.float32))
    return out
