"""EnhancedNAFNet (counterpart of ``midd_tpu/models/nafnet.py``).

intro 3x3 -> per stage [NAFBlocks, skip, 2x2/s2 down] -> middle NAFBlocks ->
per stage [1x1 (no bias) + PixelShuffle(2), resize to the skip, concat,
1x1 skip_conv, NAFBlocks] -> ending 3x3 -> +input -> crop. The input is padded
to a multiple of 2**len(enc) (NafNet/NafnetModel.py:304-309).

The model2 variant (``MODEL2_NAFNET``, Backend/model2.py:80-153) adds, behind
config flags, a multiscale intro (``multiscale_conv.{0,1,2}``, k 3, 5 and 7
on the intro's output, concatenated and fused by a 1x1 ``fusion``) and
additive skips (the decoder adds the skip after the resize; no
``skip_convs``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from midd_tpu_torch.config import NAFNetConfig
from midd_tpu_torch.models.blocks import Conv2d, NAFBlock
from midd_tpu_torch.ops.image import pad_to_multiple, resize_bilinear


class EnhancedNAFNet(nn.Module):
    def __init__(self, cfg: NAFNetConfig = NAFNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        w = cfg.width
        self.intro = Conv2d(cfg.img_channel, w, 3)
        if cfg.multiscale_intro:
            self.multiscale_conv = nn.ModuleList([Conv2d(w, w, k) for k in (3, 5, 7)])
            self.fusion = Conv2d(3 * w, w, 1)
        encoders, downs = [], []
        chan = w
        for num in cfg.enc_blk_nums:
            encoders.append(nn.Sequential(*[NAFBlock(chan) for _ in range(num)]))
            downs.append(Conv2d(chan, 2 * chan, 2, stride=2, padding=0))
            chan *= 2
        self.encoders = nn.ModuleList(encoders)
        self.downs = nn.ModuleList(downs)
        self.middle_blks = nn.Sequential(*[NAFBlock(chan) for _ in range(cfg.middle_blk_num)])
        ups, skip_convs, decoders = [], [], []
        for num in cfg.dec_blk_nums:
            ups.append(nn.Sequential(Conv2d(chan, 2 * chan, 1, bias=False), nn.PixelShuffle(2)))
            chan //= 2
            if not cfg.additive_skips:
                skip_convs.append(Conv2d(2 * chan, chan, 1))
            decoders.append(nn.Sequential(*[NAFBlock(chan) for _ in range(num)]))
        self.ups = nn.ModuleList(ups)
        self.skip_convs = nn.ModuleList(skip_convs)
        self.decoders = nn.ModuleList(decoders)
        self.ending = Conv2d(w, cfg.img_channel, 3)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.forward_with(inp, lambda blk, x: blk(x))

    def forward_with(self, inp: torch.Tensor,
                     block: Callable[[NAFBlock, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The forward with each NAFBlock applied as ``block(module, x)``
        (``ops/naf_fast.py`` routes the blocks' FFN halves through the fused
        kernel this way)."""
        h_in, w_in = inp.shape[-2:]
        inp = pad_to_multiple(inp, self.cfg.padder_size)
        if self.compute_dtype is not None:
            inp = inp.to(self.compute_dtype)
        x = self.intro(inp)
        if self.cfg.multiscale_intro:
            x = self.fusion(torch.cat([c(x) for c in self.multiscale_conv], dim=1))
        encs = []
        for enc, down in zip(self.encoders, self.downs):
            for blk in enc:
                x = block(blk, x)
            encs.append(x)
            x = down(x)
        for blk in self.middle_blks:
            x = block(blk, x)
        for s, (up, dec, skip) in enumerate(zip(self.ups, self.decoders, encs[::-1])):
            x = resize_bilinear(up(x), skip.shape[-2:])
            if self.cfg.additive_skips:
                x = x + skip
            else:
                x = self.skip_convs[s](torch.cat([x, skip], dim=1))
            for blk in dec:
                x = block(blk, x)
        x = self.ending(x) + inp
        return x[:, :, :h_in, :w_in]
