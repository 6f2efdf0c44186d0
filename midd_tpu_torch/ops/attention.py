"""Spatial self-attention core (counterpart of ``midd_tpu/ops/attention.py``).

Inputs keep the JAX package's (B, N, H, D) layout. ``mha`` dispatches on the
tensor's device: the Hopper flash kernels for CUDA tensors (differentiable:
the backward runs the dq and dk/dv kernels), the exact reference for CPU
tensors.
"""

from __future__ import annotations

import torch

from midd_tpu_torch.ops.flash_attention import mha_flash


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact multi-head attention, q,k,v: (B, N, H, D) -> (B, N, H, D).
    Scale D**-0.5 applied to q; softmax in fp32 whatever the input dtype."""
    d = q.shape[-1]
    scale = float(d) ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cuda":
        return mha_flash(q, k, v)
    return mha_reference(q, k, v)
