"""Building blocks of the port (counterpart of ``midd_tpu/models/blocks.py``).

NCHW ``nn.Module``s whose ``state_dict`` keys are the reference's torch keys
(``block1.0.weight``, ``time_mlp.1.bias``, ``sca.1.weight``, ...), so reference
``.pth`` files load with ``load_state_dict`` and ``convert.from_jax`` maps the
JAX package's trees onto them.

Precision follows the JAX package: a convolution or linear layer computes in
the dtype of its input (its weights are cast to it); normalisation computes
its statistics and affine in fp32 from fp32 parameters and casts the result
back to the input dtype. ``with_compute_dtype`` makes a copy of a model that
runs in bf16 with the matmul weights cast once.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from midd_tpu_torch.ops.attention import mha
from midd_tpu_torch.ops.ln2d import ln2d_fused


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with torch-style symmetric padding (default k//2) that
    computes in its input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         bias=bias, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, quant: Any = False) -> Conv2d:
    """``Conv2d``, or with ``quant`` (True, "dynamic", "calibrate" or
    "static") the int8 ``QuantConv2d`` with the same parameters
    (``ops/qconv.py``), as the JAX package's ``tconv(quant=...)``."""
    if quant:
        from midd_tpu_torch.ops.qconv import QuantConv2d

        return QuantConv2d(in_ch, out_ch, kernel, stride=stride, mode=quant)
    return Conv2d(in_ch, out_ch, kernel, stride=stride)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTransposeTorch(nn.ConvTranspose2d):
    """Native ``nn.ConvTranspose2d`` computing in its input's dtype. Its
    weights stay fp32 under ``with_compute_dtype`` (the fused up/down conv of
    the diffusion UNet derives its kernel from them in fp32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups, self.dilation,
        )


class GroupNorm32(nn.GroupNorm):
    """``nn.GroupNorm(groups, C)`` (eps 1e-5, biased variance) in fp32, cast
    back to the input dtype.

    The statistics come from one ``var_mean`` over (B, G, C/G*H*W) rows
    rather than ``F.group_norm``: at batch 1 the latter reduces each of the
    B*G = 8 rows in one thread block, which left 124 of the H100's 132 SMs
    idle and made it the largest kernel of a 512² UNet eval
    (chip_smoke.py --report); the generic reduction splits each
    row over many blocks."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        xf = x.float().reshape(b, self.num_groups, -1)
        var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
        y = ((xf - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5) in fp32, cast back to the input dtype,
    with the statistics of flax's ``nn.BatchNorm(momentum=0.9)``.

    In eval mode it normalises with the running statistics. In train mode it
    normalises with the batch mean and flax's fast variance, E[x²] − E[x]²
    over (N, H, W), biased and clamped at 0, and moves each running buffer a
    tenth of the way to the batch's value, the variance too biased.
    ``F.batch_norm(training=True)`` would write torch's unbiased variance
    into ``running_var`` (and take the variance in two passes), so the
    statistics are computed here."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(
                xf, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps,
            ).to(x.dtype)
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


class LayerNorm2d(nn.Module):
    """NAFNet channel LayerNorm: per-pixel statistics over channels, eps
    1e-6, fp32, with the JAX module's one-pass variance E[x²] − u² clamped
    at 0 (``midd_tpu/models/blocks.py::LayerNorm2d``). It runs through
    ``ln2d_fused``: the Hopper kernel on the card, its plain version on the
    CPU."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln2d_fused(x, self.weight, self.bias, self.eps)


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class NAFBlock(nn.Module):
    """NAFNet block (NafNet/NafnetModel.py:181-229): norm1 -> 1x1 expand(x2)
    -> 3x3 depthwise -> SimpleGate -> *SCA -> 1x1 -> +beta*residual; then
    norm2 -> 1x1 FFN(x2) -> SimpleGate -> 1x1 -> +gamma*residual."""

    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2):
        super().__init__()
        dw = c * dw_expand
        self.norm1 = LayerNorm2d(c)
        self.conv1 = Conv2d(c, dw, 1)
        self.conv2 = Conv2d(dw, dw, 3, groups=dw)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv2d(dw // 2, dw // 2, 1))
        self.conv3 = Conv2d(dw // 2, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.norm2 = LayerNorm2d(c)
        self.conv4 = Conv2d(c, ffn_expand * c, 1)
        self.conv5 = Conv2d(ffn_expand * c // 2, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(self.norm1(inp)))
        x = simple_gate(x)
        x = x * self.sca(x)
        x = self.conv3(x)
        y = inp + x * self.beta.to(x.dtype)
        x = self.conv5(simple_gate(self.conv4(self.norm2(y))))
        return y + x * self.gamma.to(x.dtype)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """SinusoidalPositionEmbeddings (DDIM/DDIMModel.py:94-106), fp32:
    freq = exp(arange(half) * -ln(10000)/(half-1)), cat(sin, cos)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * -(math.log(10000.0) / (half - 1))
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResidualBlock(nn.Module):
    """Diffusion-UNet residual block (DDIM/DDIMModel.py:108-133):
    (GN8+SiLU+3x3) -> +time-emb -> (GN8+SiLU+Dropout+3x3) -> +res_conv(x).
    ``quant`` makes its three convolutions int8 (``conv``)."""

    def __init__(self, in_c: int, out_c: int, time_emb_dim: int, dropout: float = 0.0,
                 quant: Any = False):
        super().__init__()
        self.block1 = nn.Sequential(GroupNorm32(8, in_c), nn.SiLU(), conv(in_c, out_c, 3, quant=quant))
        self.time_mlp = nn.Sequential(nn.SiLU(), Linear(time_emb_dim, out_c))
        self.block2 = nn.Sequential(
            GroupNorm32(8, out_c), nn.SiLU(), nn.Dropout(dropout), conv(out_c, out_c, 3, quant=quant)
        )
        self.res_conv = conv(in_c, out_c, 1, quant=quant) if in_c != out_c else nn.Identity()

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x)
        h = h + self.time_mlp(t_emb)[:, :, None, None].to(h.dtype)
        return self.block2(h) + self.res_conv(x)


class AttentionBlock(nn.Module):
    """Spatial self-attention (DDIM/DDIMModel.py:135-166): GN8 -> 1x1 qkv ->
    2-head softmax attention over h*w tokens -> 1x1 proj -> +x.
    ``use_flash`` as ``mha``'s (None: flash on CUDA tensors)."""

    def __init__(self, channels: int, num_heads: int = 2, use_flash: Optional[bool] = None):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.norm = GroupNorm32(8, channels)
        self.qkv = Conv2d(channels, 3 * channels, 1)
        self.proj = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hd = c // self.num_heads
        # channel order (3, heads, hd), as the NHWC reshape of the JAX block
        qkv = self.qkv(self.norm(x)).view(b, 3, self.num_heads, hd, h * w)
        qkv = qkv.permute(0, 4, 1, 2, 3)  # (B, N, 3, H, D)
        out = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], self.use_flash)  # (B, N, H, D)
        out = out.permute(0, 2, 3, 1).reshape(b, c, h, w)
        return self.proj(out) + x


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded demo weights in the JAX package's scheme: LeCun-normal conv and
    linear weights, zero biases, unit norm scales, zero NAFBlock beta/gamma,
    BatchNorm running stats (0, 1). Numbers are drawn on the CPU from
    ``generator`` and copied to the model's device, so a CPU model and a
    CUDA model built from one seed hold the same weights. A layer with
    ``zero_init = True`` gets zero weights."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
                w = mod.weight
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                if getattr(mod, "zero_init", False):
                    w.zero_()
                else:
                    draw = torch.randn(w.shape, generator=generator) * fan_in ** -0.5
                    w.copy_(draw)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.GroupNorm, LayerNorm2d, nn.BatchNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.BatchNorm2d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
                    mod.num_batches_tracked.zero_()
            elif isinstance(mod, NAFBlock):
                mod.beta.zero_()
                mod.gamma.zero_()
    return model


def with_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` that computes in ``dtype``: its conv and linear
    weights and biases are cast once; norm parameters, transposed-conv
    weights and int8 convs (which quantise from fp32 weights) stay fp32. The
    copy's ``compute_dtype`` is set, so its forward casts the inputs."""
    from midd_tpu_torch.ops.qconv import QuantConv2d

    m = copy.deepcopy(model)
    for mod in m.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)) and not isinstance(mod, QuantConv2d):
            mod.to(dtype)
    m.compute_dtype = dtype
    return m
