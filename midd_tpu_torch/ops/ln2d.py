"""NAFNet's LayerNorm2d: per-pixel statistics over the channels of an NCHW
tensor (counterpart of ``midd_tpu/ops/ln2d.py``).

On CUDA tensors ``ln2d`` launches the hand-written Hopper kernel in
``csrc/ln2d.cu``, which replaces both TPU kernels of the JAX module
(``_kernel_native`` for C < 128 and ``_kernel`` for C % 128 == 0) with one
kernel per layout (NCHW; dense channels-last, staged through shared
memory), each for any C. On CPU tensors it runs ``ln2d_plain``, a plain PyTorch
version of the same function. It never falls back from the kernel to the
plain version: a tensor the kernel does not take, a failed build or a failed
launch raises.

The formula is the JAX package's (its ``LayerNorm2d`` module and both TPU
kernels): fp32 statistics, one-pass variance E[x²] − u² clamped at 0, eps
1e-6, affine, output in the input dtype.

``ln2d_fused`` is differentiable on both devices through ``LayerNorm2dFn``,
the counterpart of the JAX ``custom_vjp``: its backward is the gradient of
the formula in plain PyTorch recomputed from the saved inputs, as
``_ln2d_bwd`` is the vjp of ``_ln2d_xla``, so there is no backward kernel.
With gradients off it saves nothing. Traced, its forward reaches the kernel
through the custom op ``midd::ln2d`` (``ln2d_op``): one opaque node in an
exported graph, which a compiled program (``utils/compile_cache.py``) calls
at run time; run eagerly, it calls ``ln2d`` directly.
"""

from __future__ import annotations

import torch

from midd_tpu_torch.ops._build import CSRC, F, I, L, P, count_launch, library, pixel_strides, raise_on, stream

SOURCE = CSRC / "ln2d.cu"
_SIGNATURES = {
    "midd_ln2d": [P] * 4 + [I] * 3 + [L] * 3 + [F, I, P],
    "midd_cuda_error_string": None,
}


def _normalise(xf, u, m2, scale, bias, eps):
    var = torch.clamp_min(m2 - u.square(), 0.0)
    out = (xf - u) / torch.sqrt(var + eps)
    return out * scale[None, :, None, None] + bias[None, :, None, None]


CHUNK = 32  # channels summed in sequence before their partial sums meet
MAX_CHANNELS = 6144  # the NCHW kernel's partial sums fill at most 48 KB of shared memory


def ln2d_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over dim 1 of (B, C, H, W) ``x`` with the JAX formula, in
    fp32 from fp32 ``scale`` and ``bias`` (C,); the result in x's dtype.

    The sums of x and x² run channel by channel in fp32 within chunks of 32
    channels, the square fused into the accumulation, and the chunks' sums
    are added in order: at C <= 32 the order and rounding of XLA's CPU
    reduction, and the kernel's order. Where the mean is large against the
    spread the one-pass variance cancels most of its bits, and the result
    then depends on that order (at 10 ± 0.05, C 32, PyTorch's own
    reductions move y by up to 5e-2)."""
    xf = x.float()
    sums = []
    for lo in range(0, xf.shape[1], CHUNK):
        s = torch.zeros_like(xf[:, :1])
        q = torch.zeros_like(s)
        for c in range(lo, min(lo + CHUNK, xf.shape[1])):
            xc = xf[:, c:c + 1]
            s = s + xc
            q = torch.addcmul(q, xc, xc)
        sums.append((s, q))
    s, q = sums[0]
    for s_k, q_k in sums[1:]:
        s, q = s + s_k, q + q_k
    # divide by a tensor on x's device: on CUDA, PyTorch turns a division by
    # a Python number into a product with its reciprocal, which is off in the
    # last bit where C is not a power of 2; the kernel, the CPU and JAX divide
    n = torch.full_like(s, xf.shape[1])
    return _normalise(xf, s / n, q / n, scale, bias, eps).to(x.dtype)


def _ln2d_formula(x, scale, bias, eps):
    """The same function with PyTorch's own reductions, differentiable in
    a few launches: what the backward differentiates (the rounding of the
    statistics does not enter the gradient's formula)."""
    xf = x.float()
    m = xf.mean(dim=1, keepdim=True)
    return _normalise(xf, m, xf.square().mean(dim=1, keepdim=True), scale, bias, eps).to(x.dtype)


def supported(x: torch.Tensor) -> bool:
    """Every channel count is covered (the JAX ``supported`` gate was a TPU
    lane rule); kept for the name."""
    return True


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] < 1 or x.numel() == 0:
        raise ValueError(f"ln2d: x must be a non-empty (B, C, H, W) tensor, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ln2d: x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"ln2d: {name} must be ({c},) float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ln2d: {name} is on {t.device}, x on {x.device}")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("ln2d: scale and bias must be contiguous")
    b, _, h, w = x.shape
    if h * w >= 2**31 or b >= 2**31 or c > MAX_CHANNELS:
        raise ValueError(f"ln2d: unsupported shape {tuple(x.shape)}")


def ln2d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm2d forward with no autograd: CUDA tensors launch the kernel
    (fp32 or bf16 x, contiguous in NCHW or channels-last order; fp32 scale
    and bias), counted in ``ln2d.launches``; CPU tensors take
    ``ln2d_plain``. y has x's layout."""
    if x.device.type == "cpu":
        return ln2d_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln2d: unsupported device {x.device}")
    _check(x, scale, bias)
    strides = pixel_strides(x, "ln2d")
    b, c, h, w = x.shape
    lib = library(SOURCE, _SIGNATURES)
    y = torch.empty_like(x)
    if y.stride() != x.stride():
        raise RuntimeError(f"ln2d: output strides {y.stride()} differ from the input's {x.stride()}")
    with torch.cuda.device(x.device):
        err = lib.midd_ln2d(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                            b, c, h * w, *strides, float(eps), int(x.dtype == torch.bfloat16),
                            stream(x))
    raise_on(err, lib, "ln2d")
    count_launch(ln2d)
    return y


ln2d.launches = 0


@torch.library.custom_op("midd::ln2d", mutates_args=())
def ln2d_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``ln2d`` as a custom op: one node in an exported graph, whose
    implementation is the wrapper. y has the layout of ``empty_like(x)``
    on both devices (the kernel allocates it so; the plain version's
    elementwise chain keeps x's), as the fake says."""
    return ln2d(x, scale, bias, eps)


@ln2d_op.register_fake
def _(x, scale, bias, eps):
    # x's layout, channels-last included: compiled code reads y with these strides
    return torch.empty_like(x)


class LayerNorm2dFn(torch.autograd.Function):
    """``ln2d`` with the gradient of the formula: the counterpart of the JAX
    ``ln2d_fused`` custom_vjp."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias)
        # the op where a graph is traced (export); eager calls launch directly
        return ln2d_op(x, scale, bias, eps) if torch.compiler.is_compiling() else ln2d(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = _ln2d_formula(*ins, ctx.eps)
            grads = iter(torch.autograd.grad(y, [t for t, n in zip(ins, need) if n], dy))
        return (*(next(grads) if n else None for n in need), None)


def ln2d_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the channels of NCHW ``x``: the kernel on the card, the
    plain version on the CPU, differentiable on both. With gradients off, or
    no input requiring them, autograd records no node and keeps nothing."""
    return LayerNorm2dFn.apply(x, scale, bias, eps)
