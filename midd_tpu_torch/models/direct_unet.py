"""ExpertDenoiser, the single-shot UNet (counterpart of
``midd_tpu/models/direct_unet.py``): double-conv (Conv+BN+ReLU) blocks, two
max-pool downs, x8 bottleneck, transposed-conv ups with skip concat, final
refine + 1x1 out. Its BatchNorm follows ``module.training``, as the JAX
module follows ``train``: batch statistics that move the running buffers in
train mode, the running statistics in eval mode (eps 1e-5)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from midd_tpu_torch.config import ExpertConfig
from midd_tpu_torch.models.blocks import BatchNorm2d, Conv2d, ConvTransposeTorch


def _double(in_ch: int, out_ch: int) -> nn.Sequential:
    """Conv-BN-ReLU x2: conv at .0/.3, BN at .1/.4."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 3, bias=False), BatchNorm2d(out_ch), nn.ReLU(),
        Conv2d(out_ch, out_ch, 3, bias=False), BatchNorm2d(out_ch), nn.ReLU(),
    )


class ExpertDenoiser(nn.Module):
    def __init__(self, cfg: ExpertConfig = ExpertConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        bc = cfg.base_channels
        self.inc = _double(cfg.in_channels, bc)
        self.down1 = _double(bc, 2 * bc)
        self.down2 = _double(2 * bc, 4 * bc)
        self.bottleneck = _double(4 * bc, 8 * bc)
        self.up2 = ConvTransposeTorch(8 * bc, 4 * bc, 2, stride=2)
        self.upconv2 = _double(8 * bc, 4 * bc)
        self.up1 = ConvTransposeTorch(4 * bc, 2 * bc, 2, stride=2)
        self.upconv1 = _double(4 * bc, 2 * bc)
        self.final = nn.Sequential(
            Conv2d(2 * bc, bc, 3, bias=False), BatchNorm2d(bc), nn.ReLU()
        )
        self.outc = Conv2d(bc, cfg.in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(F.max_pool2d(x2, 2))
        x4 = self.bottleneck(F.max_pool2d(x3, 2))
        xd2 = self.upconv2(torch.cat([self.up2(x4), x3], dim=1))
        xd1 = self.upconv1(torch.cat([self.up1(xd2), x2], dim=1))
        return self.outc(self.final(xd1))
