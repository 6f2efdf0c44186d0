"""Int8 convolutions for the diffusion UNets' serving evals (counterpart of
``midd_tpu/ops/qconv.py``).

``QuantConv2d`` has the parameters and key names of the port's ``Conv2d``, so
every checkpoint loads into a quantised model unchanged. Per output channel
the weight scale is max|w| / 127 (floored at 1e-8); the activation scale is
abs-max / 127 of the input, per call (``"dynamic"``) or from the running
``act_absmax`` that a ``"calibrate"`` pass records (``"static"``). Both
operands are rounded half to even and clipped to +-127, multiplied in int8
with int32 sums, dequantised in fp32, the bias added, and cast to the input's
dtype. Weights stay fp32 in a bf16 copy of the model, as the JAX module
quantises from its fp32 kernel.

The JAX package leaves the integer convolution to XLA, so the port builds it
from stock ops (``int8_conv2d``): im2col, then on the card one
``torch._int_mm`` (cuBLASLt, int32 sums) with K and N zero-padded to
multiples of 8 and M past 16, which leaves the sums unchanged. The plain
version (``int8_conv2d_plain``, which CPU tensors take) multiplies the same
columns in float64: every partial sum is an integer below 2**53, so it is
exact and the two agree bit for bit.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, Iterable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from midd_tpu_torch.models.blocks import Conv2d

MODES = ("dynamic", "static", "calibrate")


def quant_mode(quant: Any) -> str:
    """The model-level ``quant`` flag as a mode: True -> 'dynamic', else the
    mode string itself; an unknown string raises rather than serve a typo on
    the dynamic path."""
    mode = "dynamic" if quant is True else str(quant)
    if mode not in MODES:
        raise ValueError(
            f"unknown int8 quant mode {mode!r}: expected one of "
            "'dynamic', 'static', 'calibrate' (or True for dynamic)"
        )
    return mode


def _columns(xq: torch.Tensor, kernel: int, stride: int, padding: int):
    """im2col of an NCHW tensor as a (B, Ho, Wo, C, kh, kw) view."""
    if padding:
        xq = F.pad(xq, (padding,) * 4)
    cols = xq.unfold(2, kernel, stride).unfold(3, kernel, stride)
    return cols.permute(0, 2, 3, 1, 4, 5)


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """int8 (B, C, H, W) x int8 (O, C, k, k) -> int32 (B, O, Ho, Wo): the
    im2col columns multiplied in float64 (exact)."""
    cols = _columns(xq, wq.shape[-1], stride, padding)
    b, ho, wo = cols.shape[:3]
    a = cols.reshape(b * ho * wo, -1).double()
    y = torch.matmul(a, wq.reshape(wq.shape[0], -1).double().t())
    return y.to(torch.int32).view(b, ho, wo, -1).permute(0, 3, 1, 2)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def int8_conv2d_int_mm(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The card's form of the int8 convolution, on any device: im2col into
    a zero-padded (M', K') buffer (K' and N' multiples of 8, M' past 16, as
    ``torch._int_mm`` requires of CUDA operands; the zeros add nothing to
    the sums) and one ``torch._int_mm`` -> int32 (B, O, Ho, Wo)."""
    cols = _columns(xq, wq.shape[-1], stride, padding)
    b, ho, wo, c, kh, kw = cols.shape
    m, k, n = b * ho * wo, c * kh * kw, wq.shape[0]
    mp, kp, np_ = max(_pad8(m), 24), _pad8(k), _pad8(n)
    alloc = torch.empty if (mp, kp) == (m, k) else torch.zeros
    a = alloc((mp, kp), dtype=torch.int8, device=xq.device)
    a[:m, :k].view(b, ho, wo, c, kh, kw).copy_(cols)
    w = F.pad(wq.reshape(n, k), (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a, w.t())  # (M', N') int32; B column-major
    return y[:m, :n].view(b, ho, wo, n).permute(0, 3, 1, 2)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The int8 convolution with int32 sums: ``int8_conv2d_int_mm`` on CUDA
    tensors (counted in ``int8_conv2d.calls``), ``int8_conv2d_plain`` on CPU
    ones."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_conv2d: operands must be int8, got {xq.dtype} and {wq.dtype}")
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, stride, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv2d: unsupported device {xq.device}")
    int8_conv2d.calls += 1
    return int8_conv2d_int_mm(xq, wq, stride, padding)


int8_conv2d.calls = 0


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) half to even, clipped to +-127, as int8."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


class QuantConv2d(Conv2d):
    """``Conv2d`` (same parameters and keys) computing in int8; ``mode`` one
    of ``MODES``. ``act_absmax`` is a non-persistent buffer: a calibrate pass
    records the running abs-max of its input there (computing the exact
    fp32 convolution meanwhile), and static mode requires it."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True, mode: Any = "dynamic"):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)
        self.mode = quant_mode(mode)
        self.register_buffer("act_absmax", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride, padding = self.stride[0], self.padding[0]
        bias = None if self.bias is None else self.bias.float()
        if self.mode == "calibrate":
            m = x.float().abs().amax()
            self.act_absmax = m if self.act_absmax is None else torch.maximum(self.act_absmax, m)
            y = F.conv2d(x.float(), self.weight.float(), bias, stride, padding)
            return y.to(x.dtype)
        wf = self.weight.float()
        w_s = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
        wq = torch.round(wf / w_s[:, None, None, None]).to(torch.int8)
        if self.mode == "static":
            if self.act_absmax is None:
                raise ValueError(
                    "QuantConv2d(mode='static') needs a calibrated act_absmax: run a "
                    "mode='calibrate' pass first (midd_tpu_torch.ops.qconv.calibrate_unet_rollout)"
                )
            a_s = self.act_absmax.float().clamp_min(1e-8) / 127.0
        else:
            a_s = x.float().abs().amax().clamp_min(1e-8) / 127.0
        y = int8_conv2d(quantize(x, a_s), wq, stride, padding)
        out = y.float() * (a_s * w_s)[None, :, None, None]
        if bias is not None:
            out = out + bias[None, :, None, None]
        return out.to(x.dtype)


def qscales(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{module name: act_absmax}`` of every calibrated ``QuantConv2d``."""
    return {name: mod.act_absmax for name, mod in model.named_modules()
            if isinstance(mod, QuantConv2d) and mod.act_absmax is not None}


def load_qscales(model: nn.Module, scales: Dict[str, torch.Tensor]) -> nn.Module:
    """Set every ``QuantConv2d``'s ``act_absmax`` from ``scales`` (as
    ``qscales`` returns them); a quantised conv without one raises."""
    convs = {name: mod for name, mod in model.named_modules() if isinstance(mod, QuantConv2d)}
    missing, extra = set(convs) - set(scales), set(scales) - set(convs)
    if missing or extra:
        raise KeyError(f"qscales do not match the model's int8 convs: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, mod in convs.items():
        mod.act_absmax = torch.as_tensor(scales[name], dtype=torch.float32).to(mod.weight.device).clone()
    return model


def with_quant_mode(model: nn.Module, mode: str) -> nn.Module:
    """A copy of ``model`` whose ``QuantConv2d``s run in ``mode``."""
    mode = quant_mode(mode)
    m = copy.deepcopy(model)
    for mod in m.modules():
        if isinstance(mod, QuantConv2d):
            mod.mode = mode
    return m


def merge_qscales(a: Optional[Dict[str, torch.Tensor]],
                  b: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
    """Elementwise max of two scale sets (the union of calibration runs)."""
    if a is None:
        return b
    if b is None:
        return a
    return {k: torch.maximum(a[k], b[k]) for k in a}


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN and matmuls inside the block, restored after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def calibrate_unet_rollout(unet: nn.Module, schedule, noisy_batches: Iterable[torch.Tensor],
                           inference_steps: int,
                           scales: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Per-conv activation abs-max over full deterministic rollouts of each
    (B, 1, H, W) batch: the sampler's update (eps clamp +-5, posterior mean,
    x clamp [0, 1]) in exact fp32, the running max kept across steps and
    batches, starting from ``scales`` when given. ``unet`` is an fp32 model
    whose ``QuantConv2d``s run in ``"calibrate"`` mode (``with_quant_mode``).
    Returns the scales to serve with ``"static"`` (``load_qscales``)."""
    from midd_tpu_torch.diffusion.sampler import denoise

    if scales is not None:
        load_qscales(unet, scales)
    with exact_fp32(), torch.no_grad():
        for noisy in noisy_batches:
            denoise(unet, noisy.float(), schedule, inference_steps)
    return qscales(unet)
