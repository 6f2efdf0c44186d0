"""The served models' equations in plain fp32 PyTorch: the benchmark's frozen
reference, written from the reference service's model definitions
(KushalChaudhari-16/Medical-Image-Denoising-Using-Diffusion: DDIM/DDIMModel.py,
NafNet/NafnetModel.py, DirectUNet/DirectUNetModel.py,
hybrid3diffusionspeed.py).

The parameter names are the reference service's ``state_dict`` keys, which are
also the port's, so one seeded state dict loads into both. Nothing here
imports the port, JAX or a hand-written kernel: attention is the textbook
softmax product, LayerNorm2d the two-pass variance, and the diffusion
decoder's upsamplers run as written (transposed convolution, then the
bilinear resize to the popped skip), not as the port's fused 3x3 form.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize, half-pixel centres, no antialias; identity at the same size."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


# -- diffusion UNet (DDIM/DDIMModel.py:94-246) --------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResidualBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, temb: int):
        super().__init__()
        self.block1 = nn.Sequential(nn.GroupNorm(8, in_c), nn.SiLU(), nn.Conv2d(in_c, out_c, 3, padding=1))
        self.time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(temb, out_c))
        self.block2 = nn.Sequential(nn.GroupNorm(8, out_c), nn.SiLU(), nn.Dropout(0.0),
                                    nn.Conv2d(out_c, out_c, 3, padding=1))
        self.res_conv = nn.Conv2d(in_c, out_c, 1) if in_c != out_c else nn.Identity()

    def forward(self, x, t_emb):
        h = self.block1(x) + self.time_mlp(t_emb)[:, :, None, None]
        return self.block2(h) + self.res_conv(x)


class AttentionBlock(nn.Module):
    """GroupNorm -> 1x1 qkv (channel order 3, heads, head dim) -> softmax
    attention over the h*w positions, in blocks of query rows -> 1x1 -> +x."""

    ROWS = 1024

    def __init__(self, channels: int, heads: int = 2):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(8, channels)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.proj = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        d = c // self.heads
        q, k, v = self.qkv(self.norm(x)).view(b, 3, self.heads, d, h * w).unbind(1)  # (B, H, D, N)
        q = q.transpose(-1, -2) * d ** -0.5  # (B, H, N, D)
        out = torch.cat([torch.softmax(q[:, :, i:i + self.ROWS] @ k, dim=-1) @ v.transpose(-1, -2)
                         for i in range(0, h * w, self.ROWS)], dim=2)  # (B, H, N, D)
        return self.proj(out.transpose(-1, -2).reshape(b, c, h, w)) + x


class DiffusionUNet(nn.Module):
    """eps(x_t, condition, t) in the "ddim" skip mode: attention after every
    ResBlock at the attention levels; 13 skips pushed, 12 popped, each popped
    skip setting the working size by a bilinear resize."""

    def __init__(self, in_channels=1, model_channels=48, channel_mult=(1, 2, 3, 4), num_res_blocks=2,
                 attention_resolutions=(3,), time_emb_dim=192, skip_mode="ddim", dropout=0.0):
        super().__init__()
        if skip_mode != "ddim" or dropout:
            raise ValueError("the reference UNet is the ddim skip mode without dropout")
        mc, te = model_channels, time_emb_dim
        self.mc = mc
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(mc, te), nn.SiLU(), nn.Linear(te, te))
        self.in_conv = nn.Conv2d(2 * in_channels, mc, 3, padding=1)
        ch, skip_ch, downs, self.down_kinds = mc, [], [], []
        levels = len(channel_mult)
        for i in range(levels):
            out = mc * channel_mult[i]
            for _ in range(num_res_blocks):
                downs.append(ResidualBlock(ch, out, te))
                self.down_kinds.append("res")
                ch = out
                skip_ch.append(ch)
                if i in attention_resolutions:
                    downs.append(AttentionBlock(ch))
                    self.down_kinds.append("attn")
                    skip_ch.append(ch)
            if i != levels - 1:
                downs.append(nn.Conv2d(ch, ch, 3, stride=2, padding=1))
                self.down_kinds.append("down")
                skip_ch.append(ch)
        self.downs = nn.ModuleList(downs)
        self.mid_block1 = ResidualBlock(ch, ch, te)
        self.mid_attn = AttentionBlock(ch)
        self.mid_block2 = ResidualBlock(ch, ch, te)
        ups, self.up_kinds = [], []
        for i in reversed(range(levels)):
            out = mc * channel_mult[i]
            for _ in range(num_res_blocks + 1):
                ups.append(ResidualBlock(ch + skip_ch.pop(), out, te))
                self.up_kinds.append("res")
                ch = out
                if i in attention_resolutions:
                    ups.append(AttentionBlock(ch))
                    self.up_kinds.append("attn")
            if i != 0:
                ups.append(nn.ConvTranspose2d(ch, ch, 4, stride=2, padding=1))
                self.up_kinds.append("up")
        self.ups = nn.ModuleList(ups)
        self.out_conv = nn.Sequential(nn.GroupNorm(8, ch), nn.SiLU(), nn.Conv2d(ch, in_channels, 3, padding=1))

    def forward(self, x, condition, t):
        t_emb = self.time_mlp(timestep_embedding(t, self.mc))
        x = self.in_conv(torch.cat([x, condition], dim=1))
        skips = []
        for kind, mod in zip(self.down_kinds, self.downs):
            x = mod(x, t_emb) if kind == "res" else mod(x)
            skips.append(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t_emb)), t_emb)
        for kind, mod in zip(self.up_kinds, self.ups):
            if kind == "res":
                skip = skips.pop()
                x = mod(torch.cat([resize(x, skip.shape[-2:]), skip], dim=1), t_emb)
            else:
                x = mod(x)
        return self.out_conv(x)


# -- EnhancedNAFNet (NafNet/NafnetModel.py:181-309) ---------------------------

class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = (x - mu).pow(2).mean(1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + self.eps)
        return self.weight[None, :, None, None] * y + self.bias[None, :, None, None]


class NAFBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        dw = 2 * c
        self.norm1 = LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(dw // 2, dw // 2, 1))
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.norm2 = LayerNorm2d(c)
        self.conv4 = nn.Conv2d(c, 2 * c, 1)
        self.conv5 = nn.Conv2d(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    @staticmethod
    def gate(x):
        a, b = x.chunk(2, dim=1)
        return a * b

    def forward(self, inp):
        x = self.gate(self.conv2(self.conv1(self.norm1(inp))))
        y = inp + self.conv3(x * self.sca(x)) * self.beta
        return y + self.conv5(self.gate(self.conv4(self.norm2(y)))) * self.gamma


class NAFNet(nn.Module):
    def __init__(self, img_channel=1, width=32, middle_blk_num=8, enc_blk_nums=(2, 2, 4, 6),
                 dec_blk_nums=(2, 2, 2, 2)):
        super().__init__()
        self.pad = 2 ** len(enc_blk_nums)
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        chan, enc, downs = width, [], []
        for n in enc_blk_nums:
            enc.append(nn.Sequential(*[NAFBlock(chan) for _ in range(n)]))
            downs.append(nn.Conv2d(chan, 2 * chan, 2, stride=2))
            chan *= 2
        self.encoders, self.downs = nn.ModuleList(enc), nn.ModuleList(downs)
        self.middle_blks = nn.Sequential(*[NAFBlock(chan) for _ in range(middle_blk_num)])
        ups, skips, dec = [], [], []
        for n in dec_blk_nums:
            ups.append(nn.Sequential(nn.Conv2d(chan, 2 * chan, 1, bias=False), nn.PixelShuffle(2)))
            chan //= 2
            skips.append(nn.Conv2d(2 * chan, chan, 1))
            dec.append(nn.Sequential(*[NAFBlock(chan) for _ in range(n)]))
        self.ups, self.skip_convs, self.decoders = nn.ModuleList(ups), nn.ModuleList(skips), nn.ModuleList(dec)
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)

    def forward(self, inp):
        h, w = inp.shape[-2:]
        inp = F.pad(inp, (0, -w % self.pad, 0, -h % self.pad))
        x = self.intro(inp)
        encs = []
        for enc, down in zip(self.encoders, self.downs):
            x = enc(x)
            encs.append(x)
            x = down(x)
        x = self.middle_blks(x)
        for up, skip_conv, dec, skip in zip(self.ups, self.skip_convs, self.decoders, encs[::-1]):
            x = dec(skip_conv(torch.cat([resize(up(x), skip.shape[-2:]), skip], dim=1)))
        return (self.ending(x) + inp)[:, :, :h, :w]


# -- ExpertDenoiser (DirectUNet/DirectUNetModel.py:160-255) -------------------

def double_conv(i: int, o: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(i, o, 3, padding=1, bias=False), nn.BatchNorm2d(o), nn.ReLU(),
                         nn.Conv2d(o, o, 3, padding=1, bias=False), nn.BatchNorm2d(o), nn.ReLU())


class Expert(nn.Module):
    def __init__(self, in_channels=1, base_channels=64):
        super().__init__()
        bc = base_channels
        self.inc = double_conv(in_channels, bc)
        self.down1 = double_conv(bc, 2 * bc)
        self.down2 = double_conv(2 * bc, 4 * bc)
        self.bottleneck = double_conv(4 * bc, 8 * bc)
        self.up2 = nn.ConvTranspose2d(8 * bc, 4 * bc, 2, stride=2)
        self.upconv2 = double_conv(8 * bc, 4 * bc)
        self.up1 = nn.ConvTranspose2d(4 * bc, 2 * bc, 2, stride=2)
        self.upconv1 = double_conv(4 * bc, 2 * bc)
        self.final = nn.Sequential(nn.Conv2d(2 * bc, bc, 3, padding=1, bias=False), nn.BatchNorm2d(bc), nn.ReLU())
        self.outc = nn.Conv2d(bc, in_channels, 1)

    def forward(self, x):
        x2 = self.down1(self.inc(x))
        x3 = self.down2(F.max_pool2d(x2, 2))
        x4 = self.bottleneck(F.max_pool2d(x3, 2))
        x = self.upconv2(torch.cat([self.up2(x4), x3], dim=1))
        x = self.upconv1(torch.cat([self.up1(x), x2], dim=1))
        return self.outc(self.final(x))


# -- hybrid router and fusion (hybrid3diffusionspeed.py:470-628) --------------

def gn_block(i: int, o: int, groups: int = 8, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(i, o, 3, stride=stride, padding=1), nn.GroupNorm(groups, o), nn.GELU())


class Router(nn.Module):
    def __init__(self, in_c=1, out_c=1, base_c=32):
        super().__init__()
        bc = base_c
        self.enc1 = gn_block(in_c, bc)
        self.enc2 = gn_block(bc, 2 * bc, stride=2)
        self.enc3 = gn_block(2 * bc, 4 * bc, stride=2)
        self.mid = gn_block(4 * bc, 4 * bc)
        self.up3 = nn.ConvTranspose2d(4 * bc, 2 * bc, 2, stride=2)
        self.dec3 = gn_block(4 * bc, 2 * bc)
        self.up2 = nn.ConvTranspose2d(2 * bc, bc, 2, stride=2)
        self.dec2 = gn_block(2 * bc, bc)
        self.out_conv = nn.Conv2d(bc, out_c, 1)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        m = self.mid(self.enc3(e2))
        d3 = self.dec3(torch.cat([resize(self.up3(m), e2.shape[-2:]), e2], dim=1))
        d2 = self.dec2(torch.cat([resize(self.up2(d3), e1.shape[-2:]), e1], dim=1))
        return torch.sigmoid(self.out_conv(resize(d2, x.shape[-2:])))


class Fusion(nn.Module):
    def __init__(self, in_c=3, out_c=1, base_c=48, residual=False, sees_expert=False):
        super().__init__()
        if residual or sees_expert:
            raise ValueError("the reference fusion is the service's: not residual, three inputs")
        self.conv1 = gn_block(in_c, base_c, groups=8)
        self.conv2 = gn_block(base_c, base_c // 2, groups=4)
        self.out_conv = nn.Conv2d(base_c // 2, out_c, 1)

    def forward(self, fast, hq, mask):
        return self.out_conv(self.conv2(self.conv1(torch.cat([fast, hq, mask], dim=1))))


class HybridHeads(nn.Module):
    """The hybrid checkpoint's own modules: ``router.*`` and ``fusion.*``."""

    def __init__(self, router: Dict, fusion: Dict):
        super().__init__()
        self.router = Router(**router)
        self.fusion = Fusion(**fusion)


def build(cfg: Dict, device="cpu") -> Dict[str, nn.Module]:
    """The four checkpoints' modules of a configuration file (diffusion,
    nafnet, expert, and the hybrid's router and fusion), in eval mode, their
    tensors uninitialised on ``device``."""
    with torch.device("meta"):
        built = {
            "diffusion": DiffusionUNet(**cfg["diffusion"]),
            "nafnet": NAFNet(**cfg["nafnet"]),
            "expert": Expert(**cfg["expert"]),
            "hybrid": HybridHeads(cfg["router"], cfg["fusion"]),
        }
    return {k: (m if str(device) == "meta" else m.to_empty(device=device)).eval().requires_grad_(False)
            for k, m in built.items()}


def load(cfg: Dict, states: Dict[str, Dict[str, torch.Tensor]], device) -> Dict[str, nn.Module]:
    """The four modules holding ``states`` (``weights.draw``'s), on ``device``."""
    built = build(cfg, device)
    for name, model in built.items():
        model.load_state_dict(states[name], strict=True)
    return built
