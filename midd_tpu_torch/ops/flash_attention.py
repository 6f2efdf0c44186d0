"""Flash attention for the diffusion UNet's spatial self-attention, forward
and backward.

The counterpart of ``midd_tpu/ops/flash_attention.py``. On CUDA tensors the
work goes to hand-written Hopper kernels: the forward in ``csrc/flash_fwd.cu``,
the two backward kernels (dq; dk and dv) in ``csrc/flash_bwd.cu``. On CPU
tensors it goes to ``flash_attention_plain`` and ``flash_attention_bwd_plain``,
plain PyTorch versions of the same functions. The wrappers never fall back
from a kernel to its plain version: a tensor a kernel does not take, a failed
build or a failed launch raises.

``mha_flash`` is differentiable on both devices through ``FlashAttention``,
the counterpart of the JAX package's ``_flash_padded`` custom_vjp. A forward
with gradients off (serving runs under ``inference_mode``) saves nothing.
Traced (``torch.compiler.is_compiling()``), its forward reaches the kernel
through the custom op ``midd::flash_fwd`` (``flash_fwd_op``), so that
``torch.export`` keeps the kernel as one opaque node and a program compiled
from the graph (``utils/compile_cache.py``) calls the wrapper, and counts
its launches, at run time; run eagerly, it calls the wrapper directly.

Each kernel source is compiled with ``nvcc`` at first use, from the sources
in this package only, into ``midd_tpu_torch/build/`` (``ops/_build.py``: a
shared library with a plain C interface, loaded through ``ctypes``). Nothing
is built at import.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from midd_tpu_torch.ops._build import CSRC, NVCC_FLAGS, I as _I, P as _P, count_launch, library, raise_on

SOURCE = CSRC / "flash_fwd.cu"
# query rows per block of the plain (and the exact reference's) scores: each
# row's softmax stands alone, so blocks keep memory at O(ROW_BLOCK * N)
ROW_BLOCK = 1024
# the largest head dim the kernels take (``MAX_D`` in csrc/flash_mma.cuh):
# the served UNet's heads are 96, the wide (96-channel) UNet's 192
MAX_D = 192
BWD_SOURCE = CSRC / "flash_bwd.cu"
_SIGNATURES = {
    SOURCE: {
        "midd_flash_fwd": [_P] * 5 + [_I] * 4 + [_P],
        "midd_cuda_error_string": None,
    },
    BWD_SOURCE: {
        "midd_flash_bwd_dq": [_P] * 7 + [_I] * 4 + [_P],
        "midd_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_P],
        "midd_cuda_error_string": None,
    },
}


def _library(source=SOURCE):
    """Build (if needed) and load one of the two flash kernel libraries."""
    return library(source, _SIGNATURES[source])


def _check_qkv(name: str, *ts: torch.Tensor) -> None:
    """The checks every kernel wrapper makes on its (BH, N, D) operands."""
    q = ts[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(
            f"{name}: operands must share one (BH, N, D) shape, got "
            f"{[tuple(t.shape) for t in ts]}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != q.dtype for t in ts):
        raise ValueError(
            f"{name}: dtypes must all be bfloat16 or all float32, got "
            f"{[t.dtype for t in ts]}"
        )
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")
    bh, n, d = q.shape
    if not (1 <= d <= MAX_D) or n < 1 or not (1 <= bh <= 65535):
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")


@torch.no_grad()
def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention over (BH, N, D) in fp32: returns O in the input dtype
    and the per-row logsumexp (BH, N) in fp32. Scale 1/sqrt(D). Works
    through blocks of ``ROW_BLOCK`` query rows, in place within a block.
    Values only, as the kernel's: ``FlashAttention``'s backward computes
    the gradients."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kt, vf = k.float().transpose(-1, -2), v.float()
    os, lses = [], []
    for i in range(0, q.shape[1], ROW_BLOCK):
        s = torch.matmul(q[:, i:i + ROW_BLOCK].float(), kt).mul_(scale)
        lse = torch.logsumexp(s, dim=-1)
        os.append(torch.matmul(s.sub_(lse[..., None]).exp_(), vf))
        lses.append(lse)
    if len(os) == 1:
        return os[0].to(q.dtype), lses[0]
    return torch.cat(os, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) attention -> (O, lse). CUDA tensors launch the kernel
    (bf16 or fp32, contiguous, 1 <= D <= MAX_D); CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_qkv("flash_attention", q, k, v)
    bh, n, d = q.shape
    lib = _library(SOURCE)
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.midd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, n, d, int(q.dtype == torch.bfloat16), stream,
        )
    raise_on(err, lib, "flash_fwd")
    count_launch(flash_attention)
    return o, lse


flash_attention.launches = 0


@torch.library.custom_op("midd::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` as a custom op: one node in an exported graph,
    whose implementation is the wrapper (the kernel for CUDA tensors, the
    plain version for CPU ones)."""
    return flash_attention(q, k, v)


@flash_fwd_op.register_fake
def _(q, k, v):
    # the outputs' real layouts: O dense (BH, N, D) as the wrapper allocates
    # it for the contiguous q it takes (the plain version's is dense too),
    # lse dense (BH, N) fp32; compiled code reads them with these strides
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (BH, N), from O as the forward returned
    it (in the input dtype), as ``_flash_padded_bwd`` computes it."""
    return (do.float() * o.float()).sum(dim=-1)


def _recompute_p(q, k, lse):
    """Scores in fp32 and p = exp(scale q k^T - lse), as the TPU kernels
    recompute them (``flash_attention.py:121-122``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                     - lse[..., None]), scale


def _ds(p, v, do, delta, dtype):
    """ds = p * (dO v^T - delta), rounded to the input dtype."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * (dp - delta[..., None])).to(dtype).float()


def bwd_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """Plain version of the dq kernel: dq = scale * ds k."""
    p, scale = _recompute_p(q, k, lse)
    return (scale * torch.matmul(_ds(p, v, do, delta, q.dtype), k.float())).to(q.dtype)


def bwd_dkv_plain(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dk = scale * ds^T q, dv = p^T dO
    with p^T rounded to the input dtype."""
    p, scale = _recompute_p(q, k, lse)
    ds = _ds(p, v, do, delta, q.dtype)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward in plain PyTorch, with the TPU kernels' arithmetic:
    p is recomputed from the saved ``lse`` (BH, N) rather than by autograd of
    the forward; scores and dO v^T in fp32; ds and p^T rounded to the input
    dtype before their products; the scale applied to dq and dk at the end.
    Returns (dq, dk, dv) in the input dtype."""
    delta = _delta(o, do)
    dk, dv = bwd_dkv_plain(q, k, v, do, lse, delta)
    return bwd_dq_plain(q, k, v, do, lse, delta), dk, dv


def _launch_bwd(kernel: str, outs, q, k, v, do, lse, delta) -> None:
    lib = _library(BWD_SOURCE)
    bh, n, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, kernel)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            bh, n, d, int(q.dtype == torch.bfloat16), stream,
        )
    raise_on(err, lib, kernel)


def flash_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """Launch the dq kernel (``csrc/flash_bwd.cu``) on checked CUDA operands;
    counts its launches in ``flash_bwd_dq.launches``."""
    dq = torch.empty_like(q)
    _launch_bwd("midd_flash_bwd_dq", (dq,), q, k, v, do, lse, delta)
    count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel on checked CUDA operands; counts its launches
    in ``flash_bwd_dkv.launches``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("midd_flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta)
    count_launch(flash_bwd_dkv)
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention`` given its saved (O, lse)
    and the output cotangent dO. CUDA tensors launch the two backward kernels
    (bf16 or fp32, contiguous, 1 <= D <= MAX_D; lse (BH, N) fp32); CPU tensors
    take ``flash_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check_qkv("flash_attention_bwd", q, k, v, o, do)
    bh, n, _ = q.shape
    if (lse.shape != (bh, n) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(
            f"flash_attention_bwd: lse must be contiguous ({bh}, {n}) float32 on "
            f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}"
        )
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(BH, N, D) attention -> O, differentiable: the counterpart of
    ``_flash_padded`` and its custom_vjp. The forward saves (q, k, v, O, lse);
    the backward runs ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v):
        # the op where a graph is traced (export); eager calls launch directly,
        # without the op's dispatch (chip_smoke.py's flash_host_us times both)
        o, lse = flash_fwd_op(q, k, v) if torch.compiler.is_compiling() else flash_attention(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous())


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) attention through the flash kernels -> (B, N, H, D).
    Differentiable through ``FlashAttention``; with gradients off, or no input
    requiring them, autograd records no node and keeps no residuals."""
    b, n, h, d = q.shape

    def to_bhnd(x):
        return x.permute(0, 2, 1, 3).contiguous().view(b * h, n, d)

    out = FlashAttention.apply(to_bhnd(q), to_bhnd(k), to_bhnd(v))
    return out.view(b, h, n, d).permute(0, 2, 1, 3)
