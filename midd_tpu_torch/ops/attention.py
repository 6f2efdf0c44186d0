"""Spatial self-attention core (counterpart of ``midd_tpu/ops/attention.py``).

Inputs keep the JAX package's (B, N, H, D) layout. ``mha(..., use_flash)``
picks the path: the flash kernels (the Hopper kernels for CUDA tensors,
differentiable through the dq and dk/dv kernels; their plain versions for
CPU tensors) or the exact reference. ``use_flash=None`` takes flash on CUDA
tensors and the exact reference on CPU ones.

Both exact forms work through blocks of ``ROW_BLOCK`` query rows: each row's
softmax stands alone, so the result is the full-matrix one, and memory stays
O(ROW_BLOCK * N) at the 1024² operating point (N 16384) where the full
logits would take 1 GiB a head.
"""

from __future__ import annotations

from typing import Optional

import torch

from midd_tpu_torch.ops.flash_attention import ROW_BLOCK, mha_flash


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact multi-head attention, q,k,v: (B, N, H, D) -> (B, N, H, D).
    Scale D**-0.5 applied to q; softmax in fp32 whatever the input dtype.
    The second product takes v as its left operand, as JAX's einsum hands
    its operands to ``dot_general``, so that the padded FLOP estimate
    (``utils/flops.py``) sees the JAX package's GEMM shapes: (D, K) by
    (K, Q), not (Q, K) by (K, D)."""
    d = q.shape[-1]
    scale = float(d) ** -0.5
    qs, kf = q.float() * scale, k.float()
    vt = v.float().permute(0, 2, 3, 1)  # (B, H, D, N)
    blocks = []
    for i in range(0, q.shape[1], ROW_BLOCK):
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qs[:, i:i + ROW_BLOCK], kf), dim=-1)
        blocks.append(torch.matmul(vt, probs.transpose(-1, -2)).permute(0, 3, 1, 2))
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    return out.to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        use_flash: Optional[bool] = None) -> torch.Tensor:
    """Flash (``True``), the exact reference (``False``), or by device
    (``None``: flash for CUDA tensors)."""
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    return mha_flash(q, k, v) if use_flash else mha_reference(q, k, v)
