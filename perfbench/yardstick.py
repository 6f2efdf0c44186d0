"""The benchmark's frozen arithmetic: the card's published peaks, the
operations and bytes of the port's two kernels per call, the dense FLOPs of
a request, and the reading of a device trace. Later changes to the program
do not move it.

- Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
- A kernel call's bound is max(operations / peak, bytes / bandwidth), each
  input byte read once and each output byte written once.
- FLOPs: a copy of the port's ``utils/flops.py`` counter (the JAX package's
  convention: 2MNK a matrix product, 2 numel(out) (Cin/groups) taps a
  convolution, a transposed convolution at its output's resolution;
  elementwise work and norms excluded), run on the plain reference models
  on meta tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(ops: float, nbytes: float, peak_flops: float) -> float:
    return max(ops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def flash_fwd_cost(bh: int, n: int, d: int, dtype: str) -> Tuple[float, float, float]:
    """(operations, bytes, peak) of one flash forward over (BH, N, D): the
    two products (4 BH N^2 D); q, k, v read, O written in ``dtype``, the
    fp32 logsumexp (BH, N) written."""
    ops = 4.0 * bh * n * n * d
    nbytes = 4.0 * bh * n * d * DTYPE_BYTES[dtype] + 4.0 * bh * n
    return ops, nbytes, PEAK_FLOPS["bfloat16" if dtype == "bfloat16" else "float32"]


def ln2d_cost(b: int, c: int, h: int, w: int, dtype: str) -> Tuple[float, float, float]:
    """(operations, bytes, peak) of one LayerNorm2d over (B, C, H, W): x read
    and y written in ``dtype``, fp32 scale and bias read; about 8
    operations an element on the CUDA cores."""
    n = b * c * h * w
    return 8.0 * n, 2.0 * n * DTYPE_BYTES[dtype] + 8.0 * c, PEAK_FLOPS["float32"]


def roofline_pct(calls: List[Tuple[float, float, float]], n_kernels: int, kernel_s: float) -> Optional[float]:
    """Share of the roofline, in %: the calls' mean bound times the kernels
    the trace holds, over the kernels' time (a trace that lost records
    loses their time and their bound alike). None when nothing was read."""
    if not calls or not n_kernels or kernel_s <= 0:
        return None
    mean_bound = sum(bound_s(*c) for c in calls) / len(calls)
    return 100.0 * mean_bound * n_kernels / kernel_s


# -- dense FLOPs (a copy of midd_tpu_torch/utils/flops.py, unpadded) ---------

aten = torch.ops.aten


def _conv(numel_out: int, cout: int, k: int) -> int:
    return 2 * (numel_out // cout) * k * cout


def _convolution(out, x, w, bias, stride, padding, dilation, transposed, output_padding, groups):
    return _conv(out.numel(), out.shape[1], x.shape[1] // groups * math.prod(w.shape[2:]))


_RULES = {
    aten.mm: lambda out, a, b, *_: 2 * a.shape[0] * a.shape[1] * b.shape[1],
    aten.addmm: lambda out, c, a, b, *_: 2 * a.shape[0] * a.shape[1] * b.shape[1],
    aten.bmm: lambda out, a, b, *_: 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2],
    aten.baddbmm: lambda out, c, a, b, *_: 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2],
    aten.convolution: _convolution,
}


class FlopCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _RULES.get(func.overloadpacket)
        if rule is not None:
            self.total += rule(out, *args, *kwargs.values())
        return out


def count_flops(fn, *args) -> int:
    with FlopCounter() as counter:
        fn(*args)
    return counter.total


def request_flops(cfg: Dict) -> Dict[str, float]:
    """Dense FLOPs of one request at batch 1 by compute precision: the two
    rollouts' UNet evals (bf16), the two NAFNet forwards, the expert, the
    router and the fusion (fp32 with TF32 convolutions), on the reference
    models on meta tensors."""
    from perfbench.reference import models as ref
    from perfbench.reference import serve

    m = ref.build(cfg, "meta")
    s = cfg["img_size"]
    x = torch.empty(1, 1, s, s, device="meta")
    with torch.no_grad():
        rollout = count_flops(lambda: serve.rollout(m["diffusion"], x, cfg["schedule"], cfg["diffusion_steps"],
                                                    cfg["refresh"]))
        naf = count_flops(m["nafnet"], x)
        heads = count_flops(lambda: m["hybrid"].fusion(x, x, m["hybrid"].router(x)))
        expert = count_flops(m["expert"], x)
    return {"bfloat16": 2.0 * rollout, "tf32": 2.0 * naf + expert + heads}


def request_peak_seconds(flops: Dict[str, float]) -> float:
    """Seconds one request's dense work takes at the peaks of its precisions."""
    return sum(f / PEAK_FLOPS[p] for p, f in flops.items())


# -- device trace --------------------------------------------------------------

def union_s(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered seconds, the gaps between covered stretches) of (start, end)
    intervals in seconds."""
    covered, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


KINDS = (("flash_fwd", "flash_fwd (port kernel)"), ("ln2d", "ln2d (port kernel)"),
         ("naf_ffn", "naf_ffn (port kernel)"))


def kind(kernel: str) -> str:
    """A kernel's kind by its name (the port's kernels by their own)."""
    n = kernel.lower()
    for part, k in KINDS:
        if part in n:
            return k
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90", "wgrad", "dgrad", "cutlass")):
        return "conv / gemm (cuDNN, cuBLAS)"
    if any(s in n for s in ("norm", "welford", "reduce", "mean")):
        return "norm / reduction"
    if "upsample" in n or "interp" in n:
        return "resize"
    if any(s in n for s in ("memcpy", "memset", "copy")):
        return "copy"
    return "elementwise / other"
