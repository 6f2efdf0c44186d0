"""Conditional epsilon-prediction diffusion UNet, in both skip modes
(counterpart of ``midd_tpu/models/unet_diffusion.py``): "ddim" puts attention
after every ResBlock at the attention resolutions, "cddpm" after the first
up-ResBlock of each resolution only (cddpm/cddpmModels.py:213-224). Each
up-ResBlock takes its true input width, the working channels plus the popped
skip's, in both modes.

The reference's skip bookkeeping is kept exactly: the downs push 13 skips and
the ups pop 12 (the first skip is never consumed), and each popped skip sets
the working resolution through a bilinear shape-fix, so the decoder
ping-pongs between resolutions (DDIM/DDIMModel.py:227-246).

``fuse_updown`` (default on, as in the JAX package): where the next popped
skip sits at the resolution *before* an upsampler, the 2x transposed conv
would be bilinear-halved straight back. The two collapse into one 3x3 conv
at the input resolution whose kernel is derived from the transposed conv's
weight (``fused_updown``), with identical math. The JAX package's
``s2d_stage0`` is a TPU layout with the same parameters; the port computes
the plain layout.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from midd_tpu_torch.config import DiffusionUNetConfig
from midd_tpu_torch.models.blocks import (
    AttentionBlock,
    Conv2d,
    ConvTransposeTorch,
    GroupNorm32,
    Linear,
    ResidualBlock,
    conv,
    sinusoidal_embedding,
)
from midd_tpu_torch.ops.image import resize_bilinear
from midd_tpu_torch.parallel.tp import SplitLayer

# pool tap m of the 2x2 mean picks transposed-conv taps {2m+1, 2m+2}
_UPDOWN_A = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def fused_updown(up: ConvTransposeTorch, x: torch.Tensor) -> torch.Tensor:
    """``down2(up(x))`` for a ``ConvTranspose2d(k=4, s=2, p=1)`` as one 3x3
    conv: with k the kernel in correlation form (spatially flipped), the
    fused kernel is 0.25 * A k A^T per (in, out) slice. Derived in fp32, then
    cast to the input dtype. A tensor-parallel ``up`` computes it for each of
    its output-channel slices (differentiably in a slice's weight, under
    training at tp > 1). The convolution reads ``x`` in NCHW: an int8 UNet
    hands it a channels-last activation, and cuDNN's channels-last kernels
    sum a slice of the output channels in another order than the whole
    convolution (~3e-4 apart on an H100), which int8 rollouts amplify. Its
    padding is ``up``'s, which for k 4, s 2, p 1 is the fused 3x3's too; a
    spatial-parallel ``up`` computes it in row blocks of the 3x3
    convolution, each a copy of ``up`` with no padding along H
    (``parallel/sp.py``)."""
    if isinstance(up, SplitLayer):
        return up.map(fused_updown, x, rows=(3, 1, 1))
    a = torch.tensor(_UPDOWN_A, dtype=up.weight.dtype, device=up.weight.device)
    k = up.weight.flip(-1, -2)  # (I, O, 4, 4), correlation form
    # A k A^T as two products with the kernel on the left, in the order and
    # the orientation of the JAX model's einsum (so the padded FLOP estimate
    # of utils/flops.py sees the same GEMM shapes): over p, then over q
    i, o, p, q = k.shape
    t = torch.matmul(k.transpose(2, 3).reshape(-1, p), a.t())  # (i o q, 3)
    t = t.reshape(i, o, q, -1).transpose(2, 3).reshape(-1, q)  # (i o 3, q)
    w2 = 0.25 * torch.matmul(t, a.t()).reshape(i, o, a.shape[0], -1).permute(1, 0, 2, 3)
    return F.conv2d(x.contiguous(), w2.to(x.dtype), up.bias.to(x.dtype), padding=up.padding)


def _build_specs(cfg: DiffusionUNetConfig) -> Tuple[List, List, int]:
    """The reference constructor loops: (kind, out_ch) for downs and ups,
    and the mid channel count."""
    downs: List[Tuple[str, int]] = []
    ch = cfg.model_channels
    n_res = len(cfg.channel_mult)
    for i in range(n_res):
        out_ch = cfg.model_channels * cfg.channel_mult[i]
        for _ in range(cfg.num_res_blocks):
            downs.append(("res", out_ch))
            ch = out_ch
            if i in cfg.attention_resolutions:
                downs.append(("attn", ch))
        if i != n_res - 1:
            downs.append(("down", ch))
    mid_ch = ch
    ups: List[Tuple[str, int]] = []
    for i in reversed(range(n_res)):
        out_ch = cfg.model_channels * cfg.channel_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            ups.append(("res", out_ch))
            ch = out_ch
            if i in cfg.attention_resolutions and (cfg.skip_mode == "ddim" or j == 0):
                ups.append(("attn", ch))
        if i != 0:
            ups.append(("up", ch))
    return downs, ups, mid_ch


class UNetDiffusion(nn.Module):
    """``use_flash``: each AttentionBlock's ``mha`` path (None: flash on CUDA
    tensors). ``quant`` (False, True/"dynamic", "calibrate", "static"): int8
    convolutions in the ResidualBlocks and the stride-2 downsamplers, as
    the JAX model's ``quant``; ``in_conv``, the attention projections, the
    upsamplers and ``out_conv`` stay at full precision. The parameters are
    the same either way."""

    def __init__(self, cfg: DiffusionUNetConfig = DiffusionUNetConfig(),
                 fuse_updown: bool = True, use_flash: Optional[bool] = None,
                 quant: Any = False):
        super().__init__()
        if cfg.skip_mode not in ("ddim", "cddpm"):
            raise ValueError(f"skip_mode must be 'ddim' or 'cddpm', got {cfg.skip_mode!r}")
        self.cfg = cfg
        self.fuse_updown = fuse_updown
        self.compute_dtype: Optional[torch.dtype] = None
        downs_spec, ups_spec, mid_ch = _build_specs(cfg)
        self.down_kinds = [k for k, _ in downs_spec]
        self.up_kinds = [k for k, _ in ups_spec]
        mc, te = cfg.model_channels, cfg.time_emb_dim

        self.time_mlp = nn.Sequential(nn.Identity(), Linear(mc, te), nn.SiLU(), Linear(te, te))
        self.in_conv = Conv2d(2 * cfg.in_channels, mc, 3)

        ch = mc
        skip_ch = []
        downs = []
        for kind, arg in downs_spec:
            if kind == "res":
                downs.append(ResidualBlock(ch, arg, te, cfg.dropout, quant))
                ch = arg
            elif kind == "attn":
                downs.append(AttentionBlock(ch, use_flash=use_flash))
            else:
                downs.append(conv(ch, arg, 3, stride=2, quant=quant))
                ch = arg
            skip_ch.append(ch)
        self.downs = nn.ModuleList(downs)

        self.mid_block1 = ResidualBlock(ch, ch, te, cfg.dropout, quant)
        self.mid_attn = AttentionBlock(ch, use_flash=use_flash)
        self.mid_block2 = ResidualBlock(ch, ch, te, cfg.dropout, quant)

        ups = []
        for kind, arg in ups_spec:
            if kind == "res":
                ups.append(ResidualBlock(ch + skip_ch.pop(), arg, te, cfg.dropout, quant))
                ch = arg
            elif kind == "attn":
                ups.append(AttentionBlock(ch, use_flash=use_flash))
            else:
                ups.append(ConvTransposeTorch(ch, arg, 4, stride=2, padding=1))
                ch = arg
        self.ups = nn.ModuleList(ups)
        self.out_conv = nn.Sequential(
            GroupNorm32(8, ch), nn.SiLU(), Conv2d(ch, cfg.in_channels, 3)
        )

    def forward(self, x: torch.Tensor, condition: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        t_emb = sinusoidal_embedding(t, self.cfg.model_channels)
        if dt is not None:
            t_emb, x, condition = t_emb.to(dt), x.to(dt), condition.to(dt)
        t_emb = self.time_mlp(t_emb)

        x = self.in_conv(torch.cat([x, condition], dim=1))
        skips = []
        for kind, mod in zip(self.down_kinds, self.downs):
            x = mod(x, t_emb) if kind == "res" else mod(x)
            skips.append(x)

        x = self.mid_block1(x, t_emb)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t_emb)

        for kind, mod in zip(self.up_kinds, self.ups):
            if kind == "res":
                skip = skips.pop()
                x = resize_bilinear(x, skip.shape[-2:])
                x = mod(torch.cat([x, skip], dim=1), t_emb)
            elif kind == "attn":
                x = mod(x)
            elif self.fuse_updown and skips and skips[-1].shape[-2:] == x.shape[-2:]:
                x = fused_updown(mod, x)
            else:
                x = mod(x)
        return self.out_conv(x)
