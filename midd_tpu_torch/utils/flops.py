"""Analytic FLOP counting for the port (counterpart of
``midd_tpu/utils/flops.py``): the basis of the model-FLOP utilisation (MFU)
figure of the port's benchmarks.

``count_flops`` runs the function once under a dispatch mode and adds up the
dense-algebra operations it reaches, in the JAX module's convention, so that
the two packages give the same number for the same work:

- 2·M·N·K for every matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``
  and the int8 ``_int_mm``; ``linear``, ``matmul`` and ``einsum`` of
  matrices reach these), as the jaxpr walk counts each ``dot_general``;
- 2·numel(out)·(Cin/groups)·∏kernel for every convolution. A transposed
  convolution is counted at its OUTPUT's resolution, as the jaxpr walk
  counts the lhs-dilated ``conv_general_dilated`` that computes it (torch's
  own ``FlopCounterMode`` counts it at the input's, 4× less at stride 2).
- The backward of a convolution is counted as the convolutions that JAX's
  transpose rules emit: the input gradient as a convolution of the output
  gradient producing numel(x) values over (Cout/groups)·∏kernel (4× the
  forward for a stride-2 convolution, a quarter of it for a stride-2
  transposed one: the dilated zeros are counted, as the walk counts them),
  and the weight gradient as a convolution of the input with the output
  gradient as its kernel, producing numel(w) values over B·∏out-spatial
  (equal to the forward's count). A matrix product's backward is its two
  products, as on both sides. So forward and backward equal the JAX count
  op for op; ``tests/test_torch_flops.py`` holds both training losses to it.
- Elementwise, normalisation, resize, softmax and FFT work is excluded, as
  in the JAX module: MFU is defined on the dense-algebra FLOPs.

``lane_pad=(sub, lane)`` switches to the padded implicit-GEMM estimate of
the JAX module: M rounded up to ``sub``, K and N to ``lane``, for each
product (M the rows of the output, N its last dimension, K the contracted
length; a convolution's M is numel(out)/Cout, K (Cin/groups)·∏kernel, N
Cout; its backward's as the transposed convolutions above). The backward's
matrix products are padded in the orientation torch computes them, which
may differ from the one of JAX's transpose rule (the unpadded counts are
the same either way).

The port's hand-written kernels are opaque: a ctypes launch reaches no
operator, as a ``pallas_call`` is opaque to the jaxpr walk. Count on models
built with ``use_flash=False`` (the exact attention computes the same
products as the flash kernels, through ``einsum``) and on the module form
of the NAFNet (not ``nafnet_apply_fused``); ln2d is a norm and counts
nothing either way.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

LanePad = Optional[Tuple[int, int]]


def _pad(x: int, m: Optional[int]) -> int:
    return x if not m else -(-x // m) * m


def _product(b: int, m: int, k: int, n: int, lane_pad: LanePad) -> int:
    """2·b·M·K·N, or its padded estimate: M to ``sub``, K and N to ``lane``."""
    if lane_pad is None:
        return 2 * b * m * k * n
    sub, lane = lane_pad
    return 2 * b * _pad(m, sub) * _pad(k, lane) * _pad(n, lane)


def _conv(numel_out: int, cout: int, k: int, lane_pad: LanePad) -> int:
    """A convolution producing ``numel_out`` values over a contraction of
    ``k`` (in-channels per group times the kernel's taps): implicit GEMM
    M = numel_out / cout, K = k, N = cout."""
    return _product(1, numel_out // cout, k, cout, lane_pad)


def _mm(lane_pad, a, b):
    return _product(1, a.shape[0], a.shape[1], b.shape[1], lane_pad)


def _bmm(lane_pad, a, b):
    return _product(a.shape[0], a.shape[1], a.shape[2], b.shape[2], lane_pad)


def _convolution(lane_pad, out, x, w, bias, stride, padding, dilation, transposed,
                 output_padding, groups):
    taps = math.prod(w.shape[2:])
    return _conv(out.numel(), out.shape[1], x.shape[1] // groups * taps, lane_pad)


def _convolution_backward(lane_pad, out, g, x, w, bias_sizes, stride, padding, dilation,
                          transposed, output_padding, groups, output_mask):
    taps = math.prod(w.shape[2:])
    cin, cout = x.shape[1], g.shape[1]
    total = 0
    if output_mask[0]:  # dx: the output gradient convolved back to x's shape
        total += _conv(x.numel(), cin, cout // groups * taps, lane_pad)
    if output_mask[1]:  # dw: x convolved with the output gradient as kernel
        total += _conv(cout * (cin // groups) * taps, cout, g.shape[0] * math.prod(g.shape[2:]),
                       lane_pad)
    return total


# op -> rule(lane_pad, out, *args): the FLOPs of one call
_RULES = {
    aten.mm: lambda lp, out, a, b, *_: _mm(lp, a, b),
    aten._int_mm: lambda lp, out, a, b, *_: _mm(lp, a, b),
    aten.addmm: lambda lp, out, c, a, b, *_: _mm(lp, a, b),
    aten.bmm: lambda lp, out, a, b, *_: _bmm(lp, a, b),
    aten.baddbmm: lambda lp, out, c, a, b, *_: _bmm(lp, a, b),
    aten.convolution: _convolution,
    aten.convolution_backward: _convolution_backward,
}


class FlopCounter(TorchDispatchMode):
    """Adds the FLOPs of every dense-algebra operator run inside it to
    ``total`` (the rules above). The autograd engine carries the mode into
    the backward pass, so a ``backward()`` inside it is counted too."""

    def __init__(self, lane_pad: LanePad = None):
        super().__init__()
        self.lane_pad = tuple(lane_pad) if lane_pad is not None else None
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _RULES.get(func.overloadpacket)
        if rule is not None:
            self.total += rule(self.lane_pad, out, *args, *kwargs.values())
        return out


def count_flops(fn: Callable, *args, lane_pad: LanePad = None, **kwargs) -> int:
    """Dense-algebra (matmul + conv) FLOPs of one evaluation of ``fn(*args,
    **kwargs)``, the backward pass included when ``fn`` runs one. It runs
    ``fn`` for real, on whatever device its tensors are on.

    ``lane_pad=(sub, lane)`` switches to the PADDED-work estimate: each
    GEMM dimension rounded up to its tile (the TPU's MXU tile is (8, 128);
    the port's training benchmark takes a Hopper one). Model FLOPs over
    padded FLOPs is the padding-waste factor."""
    with FlopCounter(lane_pad) as counter:
        fn(*args, **kwargs)
    return counter.total


# Peak dense bf16 throughput per card, by ``torch.cuda.get_device_name``:
# the published figure without sparsity.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,  # H100 SXM5: 989 TFLOP/s bf16 dense (495 TF32)
}


def device_peak_tflops(device=None) -> float:
    """Peak dense bf16 TFLOP/s of ``device`` (None: the current CUDA device).
    Raises ``ValueError`` naming the device for the CPU or a card not in
    ``PEAK_TFLOPS``: a guessed peak would print a wrong MFU without a word
    (the JAX function falls back to the TPU v5e's figure)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no peak TFLOP/s for device {device}: MFU is defined on the card of record, "
                         f"one of {sorted(PEAK_TFLOPS)}")
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_TFLOPS:
        raise ValueError(f"no peak TFLOP/s for {name!r} ({device}); known cards: {sorted(PEAK_TFLOPS)}")
    return PEAK_TFLOPS[name]


def mfu(total_flops: float, seconds: float, peak_tflops: float) -> float:
    return total_flops / seconds / (peak_tflops * 1e12)
