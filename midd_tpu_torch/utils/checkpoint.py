"""Checkpoint I/O of the port (counterpart of ``midd_tpu/utils/checkpoint.py``).

The JAX package writes orbax trees plus a ``metadata.json``; the port writes
one ``<ckpt_dir>/<ckpt_name>.pth`` in the reference's torch format
(DDIM/DDIMModel.py:429-435, hybrid3diffusionspeed.py:837-852):
``model_state_dict``, ``optimizer_state_dict`` and the metadata keys (epoch,
best_psnr, best_ssim, the histories, the flattened arch fields) at the top
level. The port's serving engine reads exactly this file.

The port imports no jax, so it cannot read or write orbax directories: the
engine and the recipes refuse one with ``orbax_message``. ``orbax_bridge.py``
at the repository root converts in both directions on a host with jax
(``to-pth``, ``to-orbax``, and ``dir`` for a whole checkpoint directory).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist


def save_checkpoint(path: str, model_state_dict: Mapping[str, torch.Tensor],
                    optimizer_state_dict: Optional[Dict[str, Any]] = None,
                    metadata: Optional[Dict[str, Any]] = None, replicas=None) -> str:
    """Write ``path`` (a ``.pth`` file) atomically: a reader never sees a
    half-written file. Model tensors are stored on the CPU. ``replicas``: a
    process group whose ranks hold equal copies of the state (data
    parallel): its first rank writes the one file, and every rank returns
    once it is written."""
    path = os.path.abspath(path)
    if replicas is None or dist.get_rank(replicas) == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload: Dict[str, Any] = dict(metadata or {})
        payload["model_state_dict"] = {k: v.detach().cpu() for k, v in model_state_dict.items()}
        if optimizer_state_dict is not None:
            payload["optimizer_state_dict"] = optimizer_state_dict
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if replicas is not None:
        dist.barrier(group=replicas)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by ``save_checkpoint`` (or a reference
    ``.pth``) onto the CPU. ``path`` may omit the ``.pth`` suffix, as the JAX
    package's checkpoint paths do."""
    if not os.path.exists(path) and os.path.exists(path + ".pth"):
        path += ".pth"
    return torch.load(path, map_location="cpu", weights_only=True)


def orbax_message(path: str) -> str:
    """The error for an orbax checkpoint directory: what it is, and the
    converter command that makes a ``.pth`` of it."""
    path = os.path.normpath(path)
    return (f"{path!r} is an orbax checkpoint directory; the port reads .pth files only. "
            f"Convert it on a host with jax: python orbax_bridge.py to-pth {path} {path}.pth "
            f"(or python orbax_bridge.py dir SRC_DIR OUT_DIR for a whole checkpoint directory)")
