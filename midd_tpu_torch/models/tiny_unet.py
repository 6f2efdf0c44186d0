"""TinyUNet, the 785K-parameter experimental conditional UNet (counterpart of
``midd_tpu/models/tiny_unet.py``; newfastmodel/modelfunctions.py:64-164):
double-conv (conv + GN8 + SiLU) blocks, average-pool downs, bilinear ups, a
time embedding added once at the bottleneck; data in [-1, 1].

The module names are the reference's torch keys (``time_emb.0``,
``inc.net.3``, ``down1.conv.net.0``, ``outc.2``, ...), so the JAX package's
trees convert onto them through ``convert.from_jax``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from midd_tpu_torch.config import TinyUNetConfig
from midd_tpu_torch.models.blocks import Conv2d, GroupNorm32, Linear, sinusoidal_embedding
from midd_tpu_torch.ops.image import resize_bilinear


class ConvBlock(nn.Module):
    """(Conv3x3 + GN8 + SiLU) x2 (modelfunctions.py:64-77)."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(in_c, out_c, 3), GroupNorm32(8, out_c), nn.SiLU(),
            Conv2d(out_c, out_c, 3), GroupNorm32(8, out_c), nn.SiLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _Down(nn.Module):
    """2x2 average pool, then a ConvBlock (modelfunctions.py:82-89)."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv = ConvBlock(in_c, out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.avg_pool2d(x, 2))


class _Up(nn.Module):
    """Bilinear 2x upsample, a bilinear shape-fix to the skip's size, concat
    the skip, then a ConvBlock (modelfunctions.py:94-106)."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv = ConvBlock(in_c, out_c)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = resize_bilinear(x, skip.shape[-2:])
        return self.conv(torch.cat([x, skip], dim=1))


class TinyUNet(nn.Module):
    def __init__(self, cfg: TinyUNetConfig = TinyUNetConfig()):
        super().__init__()
        self.cfg = cfg
        c, td = cfg.base_ch, cfg.time_dim
        self.time_emb = nn.Sequential(Linear(td, td), nn.SiLU(), Linear(td, td))
        self.time_proj = Linear(td, 4 * c)
        self.inc = ConvBlock(cfg.in_ch, c)
        self.down1 = _Down(c, 2 * c)
        self.down2 = _Down(2 * c, 4 * c)
        self.mid = ConvBlock(4 * c, 4 * c)
        self.up2 = _Up(4 * c + 2 * c, 2 * c)
        self.up1 = _Up(2 * c + c, c)
        self.outc = nn.Sequential(GroupNorm32(8, c), nn.SiLU(), Conv2d(c, 1, 1))

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                cond_image: torch.Tensor) -> torch.Tensor:
        te = self.time_proj(self.time_emb(sinusoidal_embedding(timesteps, self.cfg.time_dim)))
        x1 = self.inc(torch.cat([latents, cond_image], dim=1))
        x2 = self.down1(x1)
        x3 = self.down2(x2) + te[:, :, None, None]
        x = self.up2(self.mid(x3), x2)
        return self.outc(self.up1(x, x1))
