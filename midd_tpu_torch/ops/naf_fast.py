"""Kernel-fused functional NAFNet forward (counterpart of
``midd_tpu/ops/naf_fast.py``).

``nafnet_apply_fused(model, x)`` computes what the port's ``EnhancedNAFNet``
computes, reading that module's parameters, with each NAFBlock's FFN half
(norm2, conv4, SimpleGate, conv5, gamma) run by ``naf_ffn_fused``: the
hand-written kernel on the card, its plain version on the CPU. norm1 is the
centred LayerNorm in plain ops, as ``naf_fast.py:52-57`` leaves it to XLA.

Unlike the JAX forward, which fuses only at C >= ``MIN_FUSED_CHANNELS`` =
128, it fuses at every C: that threshold existed because the TPU kernel
padded C to 128 lanes, and the function computed is the same either way.

Forward only (``naf_ffn_fused`` raises with gradients on); no engine path
calls it, as in the JAX package.
"""

from __future__ import annotations

import torch

from midd_tpu_torch.models.blocks import NAFBlock, simple_gate
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.ops.naf_ffn import naf_ffn_fused


def _layernorm2d(norm, x: torch.Tensor) -> torch.Tensor:
    """norm1 as ``naf_fast._layernorm2d``: centred variance, eps 1e-6, fp32."""
    xf = x.float()
    d = xf - xf.mean(dim=1, keepdim=True)
    var = d.square().mean(dim=1, keepdim=True)
    out = d / torch.sqrt(var + 1e-6) * norm.weight[None, :, None, None] + norm.bias[None, :, None, None]
    return out.to(x.dtype)


def _nafblock(blk: NAFBlock, inp: torch.Tensor) -> torch.Tensor:
    x = blk.conv2(blk.conv1(_layernorm2d(blk.norm1, inp)))
    x = simple_gate(x)
    x = blk.conv3(x * blk.sca(x))
    y = inp + x * blk.beta.to(x.dtype)
    # bf16 copies of a model keep fp32 norms and gamma but cast their convs;
    # the kernel takes fp32 parameters (its math is fp32, as on the TPU)
    return naf_ffn_fused(y, blk.norm2.weight, blk.norm2.bias,
                         blk.conv4.weight.float(), blk.conv4.bias.float(),
                         blk.conv5.weight.float(), blk.conv5.bias.float(), blk.gamma.float())


def nafnet_apply_fused(model: EnhancedNAFNet, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` with every FFN half through the fused kernel. Call it
    with gradients off."""
    return model.forward_with(x, _nafblock)
