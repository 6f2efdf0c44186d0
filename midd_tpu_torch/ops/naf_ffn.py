"""The FFN half of a NAFBlock, fused (counterpart of ``midd_tpu/ops/naf_ffn.py``).

    out = y + (W5 · SimpleGate(W4 · LN(y) + b4) + b5) · gamma

per pixel of NCHW ``y``, with LN the centred-variance LayerNorm (eps 1e-6)
of the TPU kernel. On CUDA tensors ``naf_ffn_fused`` launches the
hand-written Hopper kernel in ``csrc/naf_ffn.cu``; on CPU tensors it runs
``naf_ffn_plain``, a plain PyTorch version of the same function. It never
falls back from the kernel to the plain version.

Forward only, like the JAX kernel: with gradients on and an input that
requires them, it raises on both devices rather than return a result with
no gradient.
"""

from __future__ import annotations

import torch

from midd_tpu_torch.ops._build import CSRC, I, L, P, library, pixel_strides, raise_on, stream

SOURCE = CSRC / "naf_ffn.cu"
_SIGNATURES = {
    "midd_naf_ffn": [P] * 9 + [I] * 3 + [L] * 3 + [I, P],
    "midd_naf_ffn_max_channels": [],
    "midd_cuda_error_string": None,
}


def _params(c, scale, bias, w4, b4, w5, b5, gamma):
    """The parameters as (C,) / (2C, C) / (C, C) views, as the port's modules
    hold them: conv weights (out, in, 1, 1), gamma (1, C, 1, 1)."""
    return (scale.reshape(c), bias.reshape(c), w4.reshape(2 * c, c), b4.reshape(2 * c),
            w5.reshape(c, c), b5.reshape(c), gamma.reshape(c))


def naf_ffn_plain(y, scale, bias, w4, b4, w5, b5, gamma) -> torch.Tensor:
    """The fused FFN half in plain PyTorch: fp32 math, result in y's dtype."""
    b, c, h, w = y.shape
    scale, bias, w4, b4, w5, b5, gamma = (t.float() for t in _params(c, scale, bias, w4, b4, w5, b5, gamma))
    x = y.float().reshape(b, c, h * w)
    u = x.mean(dim=1, keepdim=True)
    d = x - u
    var = d.square().mean(dim=1, keepdim=True)
    xn = d / torch.sqrt(var + 1e-6) * scale[:, None] + bias[:, None]
    hid = torch.matmul(w4, xn) + b4[:, None]
    g = hid[:, :c] * hid[:, c:]
    out = x + (torch.matmul(w5, g) + b5[:, None]) * gamma[:, None]
    return out.reshape(b, c, h, w).to(y.dtype)


def _check(y, params) -> None:
    if y.dim() != 4 or y.numel() == 0:
        raise ValueError(f"naf_ffn: y must be a non-empty (B, C, H, W) tensor, got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"naf_ffn: y must be float32 or bfloat16, got {y.dtype}")
    for t in params:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != y.device:
            raise ValueError(
                f"naf_ffn: parameters must be contiguous float32 on {y.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    b, c, h, w = y.shape
    if h * w >= 2**31 or b >= 2**31:
        raise ValueError(f"naf_ffn: unsupported shape {tuple(y.shape)}")


def naf_ffn_fused(y, scale, bias, w4, b4, w5, b5, gamma) -> torch.Tensor:
    """The FFN half of a NAFBlock on (B, C, H, W) ``y``. ``scale``, ``bias``:
    norm2's (C,); ``w4`` (2C, C[, 1, 1]), ``b4`` (2C,): conv4; ``w5`` (C, C[,
    1, 1]), ``b5`` (C,): conv5; ``gamma`` (C,) or (1, C, 1, 1). CUDA tensors
    launch the kernel (fp32 or bf16 y, contiguous in NCHW or channels-last
    order; fp32 contiguous parameters; for bf16 y the kernel's tensor-core
    products take xn, the gate and the conv weights rounded to bf16, and the
    weights are cast here, once a call), counted in
    ``naf_ffn_fused.launches``; CPU tensors take ``naf_ffn_plain``. The
    result has y's layout."""
    ts = (y, scale, bias, w4, b4, w5, b5, gamma)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "naf_ffn_fused is forward only, as the JAX kernel is; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    if y.device.type == "cpu":
        return naf_ffn_plain(*ts)
    if y.device.type != "cuda":
        raise ValueError(f"naf_ffn: unsupported device {y.device}")
    if y.dim() != 4:
        raise ValueError(f"naf_ffn: y must be (B, C, H, W), got {tuple(y.shape)}")
    b, c, h, w = y.shape
    sizes = (c, c, 2 * c * c, 2 * c, c * c, c, c)
    if any(t.numel() != n for t, n in zip(ts[1:], sizes)):
        raise ValueError(
            f"naf_ffn: parameter sizes {[t.numel() for t in ts[1:]]} do not fit C = {c}"
        )
    _check(y, ts[1:])
    strides = pixel_strides(y, "naf_ffn")
    params = list(_params(c, scale, bias, w4, b4, w5, b5, gamma))  # views: all are contiguous
    if y.dtype == torch.bfloat16:  # the kernel's bf16 products take bf16 weights: cast once a call
        params[2], params[4] = params[2].to(torch.bfloat16), params[4].to(torch.bfloat16)
    lib = library(SOURCE, _SIGNATURES)
    if c > lib.midd_naf_ffn_max_channels():
        raise ValueError(f"naf_ffn: C = {c} does not fit a block's shared memory "
                         f"(at most {lib.midd_naf_ffn_max_channels()})")
    out = torch.empty_like(y)
    if out.stride() != y.stride():
        raise RuntimeError(f"naf_ffn: output strides {out.stride()} differ from the input's {y.stride()}")
    with torch.cuda.device(y.device):
        err = lib.midd_naf_ffn(y.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
                               b, c, h * w, *strides, int(y.dtype == torch.bfloat16), stream(y))
    raise_on(err, lib, "naf_ffn")
    naf_ffn_fused.launches += 1
    return out


naf_ffn_fused.launches = 0
