"""Hybrid routing components and the hybrid graph (counterpart of
``midd_tpu/models/hybrid.py``, reference hybrid3diffusionspeed.py:470-628),
for serving and for training the router and the fusion on frozen backends."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from midd_tpu_torch.config import FusionConfig, RouterConfig
from midd_tpu_torch.models.blocks import Conv2d, ConvTransposeTorch, GroupNorm32
from midd_tpu_torch.ops.image import resize_bilinear


def _block(in_ch: int, out_ch: int, groups: int = 8, stride: int = 1) -> nn.Sequential:
    """3x3 conv -> GroupNorm -> exact-erf GELU (conv at .0, norm at .1)."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 3, stride=stride), GroupNorm32(groups, out_ch), nn.GELU()
    )


class NoiseAnalyzer(nn.Module):
    """Routing-mask UNet: 3-level encoder, transposed-conv ups resized to the
    skips, 1x1 + sigmoid per-pixel mask at the input size."""

    def __init__(self, cfg: RouterConfig = RouterConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        bc = cfg.base_c
        self.enc1 = _block(cfg.in_c, bc)
        self.enc2 = _block(bc, 2 * bc, stride=2)
        self.enc3 = _block(2 * bc, 4 * bc, stride=2)
        self.mid = _block(4 * bc, 4 * bc)
        self.up3 = ConvTransposeTorch(4 * bc, 2 * bc, 2, stride=2)
        self.dec3 = _block(4 * bc, 2 * bc)
        self.up2 = ConvTransposeTorch(2 * bc, bc, 2, stride=2)
        self.dec2 = _block(2 * bc, bc)
        self.out_conv = Conv2d(bc, cfg.out_c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        m = self.mid(e3)
        d3 = resize_bilinear(self.up3(m), e2.shape[-2:])
        d3 = self.dec3(torch.cat([d3, e2], dim=1))
        d2 = resize_bilinear(self.up2(d3), e1.shape[-2:])
        d2 = self.dec2(torch.cat([d2, e1], dim=1))
        d2 = resize_bilinear(d2, x.shape[-2:])
        return torch.sigmoid(self.out_conv(d2))


class FusionModule(nn.Module):
    """cat([fast, hq, mask(, expert)]) -> 3x3+GN8+GELU -> 3x3+GN4+GELU -> 1x1.
    ``cfg.residual``: the 1x1 head is zero-initialised and its output is
    added to the NAFNet branch. ``cfg.sees_expert``: one more input channel,
    the expert branch."""

    def __init__(self, cfg: FusionConfig = FusionConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        bc = cfg.base_c
        self.conv1 = _block(cfg.in_c + int(cfg.sees_expert), bc, groups=8)
        self.conv2 = _block(bc, bc // 2, groups=4)
        self.out_conv = Conv2d(bc // 2, cfg.out_c, 1)
        self.out_conv.zero_init = cfg.residual

    def forward(self, nafnet_out: torch.Tensor, diffusion_out: torch.Tensor,
                routing_mask: torch.Tensor,
                expert_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        ins = [nafnet_out, diffusion_out, routing_mask]
        if self.cfg.sees_expert:
            if expert_out is None:
                raise ValueError("FusionConfig.sees_expert=True requires the expert branch")
            ins.append(expert_out)
        x = torch.cat(ins, dim=1)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.conv2(self.conv1(x))
        if self.cfg.residual:
            delta = self.out_conv(x)
            return nafnet_out.to(delta.dtype) + delta
        return self.out_conv(x)


class RouterFusion(nn.Module):
    """The hybrid's trainable part, the router and the fusion: its
    ``state_dict`` holds the ``router.*`` and ``fusion.*`` keys of a hybrid
    checkpoint, which the engine serves beside its standalone backends."""

    def __init__(self, router_cfg: RouterConfig = RouterConfig(),
                 fusion_cfg: FusionConfig = FusionConfig()):
        super().__init__()
        self.router = NoiseAnalyzer(router_cfg)
        self.fusion = FusionModule(fusion_cfg)


def _sanitize(x: torch.Tensor) -> torch.Tensor:
    """nan_to_num(nan=0, posinf=1, neginf=0) + clamp [0, 1]
    (hybrid3diffusionspeed.py:613-624)."""
    return torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0).clamp(0.0, 1.0)


def hybrid_forward(
    nafnet_apply: Callable,
    denoise_fn: Callable,
    router_apply: Callable,
    fusion_apply: Callable,
    noisy: torch.Tensor,
    expert_apply: Optional[Callable] = None,
) -> torch.Tensor:
    """The hybrid graph: fusion(sanitized NAFNet, sanitized rollout,
    sanitized router mask[, sanitized expert]). The backends (NAFNet,
    rollout, expert) run under ``torch.no_grad()``, the reference's frozen
    backends (hybrid3diffusionspeed.py:613-620,669): in training, gradients
    reach the router and the fusion only."""
    with torch.no_grad():
        fast = _sanitize(nafnet_apply(noisy))
        hq = _sanitize(denoise_fn(noisy))
        exp = _sanitize(expert_apply(noisy)) if expert_apply is not None else None
    mask = _sanitize(router_apply(noisy))
    if exp is not None:
        return fusion_apply(fast, hq, mask, exp)
    return fusion_apply(fast, hq, mask)
