"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels from this checkout and holds each against its plain PyTorch version,
serves full-width 512² /denoise requests through the port's HTTP server,
runs the kernel-fused NAFNet forward, trains the full-width diffusion UNet
and NAFNet through the port's training CLI and serves the checkpoints they
wrote, and checks the card against the CPU on one exact rollout, one NAFNet
forward and one training step of each model.

    python3 chip_smoke.py [--report FILE]

Phases (any failure exits non-zero, and no result line is printed):
1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/ln2d.cu and
   csrc/naf_ffn.cu with nvcc, all four at once;
3. forward kernel vs plain: flash_attention (tensor cores: bf16 in one
   pass, fp32 in three TF32 passes) against flash_attention_plain (TF32
   off) at the served shapes and a few others; timed at the three served
   sequence lengths (N 1024, 4096, 16384; D 96; bf16) and at the training
   shape (2, 4096, 96) in fp32, each call alone (``ms``) and 5 in a row
   (``ms_batched``), each beside SDPA timed the same two ways in the same
   dtype and the bound (operations over the bf16 or the TF32 peak);
4. backward kernels vs plain: flash_bwd_dq and flash_bwd_dkv against their
   plain versions (TF32 off), timed as in phase 3 at the same shapes
   beside SDPA's backward in the same dtype (its device time under the
   profiler) and their bounds;
5. ln2d kernel vs plain at every SERVE_NAFNET stage shape of a 512² input
   (batch 1 and 2) and one ragged shape, fp32 and bf16, with timings (as in
   phase 3, and one call's device time under the profiler) and
   ``F.layer_norm`` on a channels-last copy as yardstick, and
   untimed at the channels-last kernel's edges (small P, C 1 and 7, a view
   off 16-byte alignment); fp32 must equal the plain version bit for bit
   where C is a power of 2;
6. naf_ffn kernel vs plain at the same shapes, fp32 and bf16, with timings;
7. fused NAFNet forward: ``nafnet_apply_fused`` at SERVE_NAFNET, 512², fp32,
   against the module's forward (TF32 off); exactly 30 naf_ffn launches;
8. serving slice: InferenceEngine(EngineConfig()) at 512² with seeded demo
   weights behind the stdlib server; 3 multipart requests, four non-null
   PNGs each, exactly 48 flash forward, 120 ln2d (the nafnet path and the
   hybrid's NAFNet backend) and no backward launches per request;
9. card vs CPU: one exact fp32 diffusion rollout and one fp32 NAFNet forward
   at 256² on both devices;
10. one training step, card vs CPU, of each model at 128², fp32, TF32 off,
   same weights and batch: SERVE_DIFFUSION (6 forward, 6 dq and 6 dk/dv
   launches) and SERVE_NAFNET (60 ln2d launches; every LayerNorm2d weight
   and bias gets a gradient); loss and every parameter gradient compared;
11. training slices: ``recipes.main`` --model diffusion (512², 1 epoch, 4
   seeded synthetic pairs, batch 1 = 4 train steps of 6/6/6 launches and a
   validation rollout of 17 evals) and --model nafnet (512², 1 epoch, 8
   pairs, batch 2 = 4 train steps of 60 ln2d launches and one validation
   forward); finite losses, moved parameters, a .pth with its metadata;
   then an InferenceEngine on each checkpoint answers one 512² request.
Where ``torch.profiler`` records no device kernel three times running, it
is off for the rest of the run and device times are taken by CUDA events
behind a sleep kernel instead (``device_ms_events``); the ``total_s`` line
counts such fallbacks under ``profiler``.
The second-to-last line is the kernels JSON (each flash entry with an
``fp32`` object and the times of every timed shape), the last
{"ok": true, ...}.

``--report FILE`` also measures where a request's and a training step's time
goes and writes a longer JSON report to FILE: every request and path time, 6
more HTTP requests and 6 in-process ``process_all`` calls, each path's wall
time (median of 5) beside its device time under ``torch.profiler`` (by kernel
kind, top kernels, idle share = 1 - device / wall), ``F.group_norm`` against
the port's ``GroupNorm32`` at the largest GroupNorm input of a 512² UNet
eval, the host time per serving call of the flash forward through its
autograd Function against a direct call, the device time by kernel kind of
one ``nafnet_apply_fused`` call and one module forward at 512², the sums
over one NAFNet forward of the ln2d and naf_ffn per-call times of phases 5
and 6 (computed from isolated calls, not measured in a forward), and the
same wall/device breakdown for one 512² training step of each model.
"""

from __future__ import annotations

import base64
import contextlib
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from midd_tpu_torch import config
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import GroupNorm32, LayerNorm2d, init_weights
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops import _build
from midd_tpu_torch.ops import flash_attention as fa
from midd_tpu_torch.ops import ln2d as ln
from midd_tpu_torch.ops import naf_ffn as ffn
from midd_tpu_torch.ops.naf_fast import nafnet_apply_fused
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.serve.server import make_server
from midd_tpu_torch.train import recipes
from midd_tpu_torch.train.data import to_device
from midd_tpu_torch.train.trainer import (Trainer, diffusion_draw, diffusion_loss_fn,
                                          nafnet_loss_fn, no_draw)

# H100 SXM data sheet (dense): bf16 and TF32 tensor-core peaks, fp32
# CUDA-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# (bh, n, d, dtype). The plain version runs in fp32 on the same (for bf16:
# bf16-rounded) inputs, with TF32 off.
# Each flash kernel and SDPA's forward (and in phase 5 ln2d and
# F.layer_norm) is timed twice: "ms" with events around each call alone, as
# every kernel of the kernels line (the host's launch of the call is inside),
# and "ms_batched" over 5 calls in a row, divided by 5.
FLASH_BATCH = 5
MAIN = (2, 4096, 96, torch.bfloat16)
CASES = [
    MAIN,
    (2, 4096, 96, torch.float32),
    (2, 1024, 96, torch.bfloat16),
    (2, 16384, 96, torch.bfloat16),
    (2, 1000, 64, torch.float32),
    (2, 1000, 64, torch.bfloat16),
    (2, 64, 8, torch.float32),
]
# lse is computed from fp32 scores on both sides, in another summation order
# (measured <= 2e-6 on the H100); so is O in fp32 (measured <= 6e-7).
TOL_FP32 = 1e-5
# bf16 O: the kernel rounds p to bf16 before p.v (relative error <= 2^-9 per
# term, random in sign) and O to bf16 on output (<= 2^-9 of |O|). Two bf16
# ulps of the largest output, 2^-7 * max|O|, holds both (measured at a third
# to a half of it); an absolute bound would have to be sized for |O| near 1,
# while these outputs are 0.01-0.3.
BF16_O_REL = 2.0 ** -7
PROFILE_REQUESTS = 6
PER_REQUEST = {
    "flash_fwd": 48,  # (4 diffusion + 4 hybrid UNet evals) x 6 attention blocks
    "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "ln2d": 120,  # (nafnet path + the hybrid's NAFNet backend) x 30 NAFBlocks x 2 norms
    "naf_ffn": 0,  # no engine path runs the fused functional forward
}
CARD_VS_CPU_BOUND = 1e-3

# SERVE_NAFNET at 512²: (C, H = W) of each stage, and the LayerNorm2d calls
# (2 per NAFBlock) and FFN halves (1 per NAFBlock) one forward makes there:
# encoders (2, 2, 4, 6) at C 32..256, 8 middle blocks at C 512, decoders
# (2, 2, 2, 2) at C 256..32.
NAF_STAGES = [(32, 512), (64, 256), (128, 128), (256, 64), (512, 32)]
NAF_BLOCKS = {32: 4, 64: 4, 128: 6, 256: 8, 512: 8}
NAF_RAGGED = (48, 37, 29)  # (C, H, W): C not a multiple of 32, odd H*W
# (b, c, h, w, dtype, layout): the staged channels-last kernel at its edges,
# checked and not timed: small P (C 512 at 4x4: one and two blocks of 8
# pixels), C 1 and C 7 (bf16: C * 2 not a multiple of 16, so scalar loads),
# and a view one element into its storage (scalar loads)
LN_EDGE_CASES = [
    (1, 512, 4, 4, torch.float32, "channels_last"), (2, 512, 4, 4, torch.float32, "channels_last"),
    (2, 512, 4, 4, torch.bfloat16, "channels_last"),
    (2, 1, 9, 7, torch.float32, "channels_last"), (2, 7, 9, 7, torch.float32, "channels_last"),
    (2, 7, 9, 7, torch.bfloat16, "channels_last"),
    (2, 64, 9, 7, torch.float32, "channels_last_offset"),
    (2, 64, 9, 7, torch.bfloat16, "channels_last_offset"),
]
# ln2d fp32: the kernel takes its sums in the plain version's order with
# every step rounded as written and divides by C, as the CPU and JAX do. On
# the card the plain version's division by a Python int is PyTorch's product
# with 1/C, exact where C is a power of 2: there the two agree to the last
# bit, which phase 5 requires (elsewhere they differ in the last bit of the
# mean). 1e-5 of max|y| alone would still hold a summation in another order
# (about sqrt(C) ulps of E[x^2], amplified by mean^2 / var ~ 7 at these
# inputs, whose mean is 2.5x their spread), while a fault of one term in
# 10^4 would not fit.
LN_FP32_REL = 1e-5
# bf16: both sides compute in fp32 from the same bf16 inputs and round once
# to bf16; where the fp32 values straddle a rounding boundary they differ by
# one bf16 ulp: two ulps of the largest output, 2^-7 * max|y|, as for the
# flash kernels.
LN_BF16_REL = 2.0 ** -7
# naf_ffn fp32: the two products sum C (then C) terms in another order than
# cuBLAS (TF32 off): ~sqrt(C) * 2^-24 of the terms' size each, so ~1e-6 of
# max|out| at C 512; 1e-5 leaves a margin while a TF32 product (2^-11) would
# not fit. bf16: as for ln2d.
FFN_FP32_REL = 1e-5
FFN_BF16_REL = 2.0 ** -7
# nafnet_apply_fused vs the module, fp32, TF32 off: the same convolutions;
# norm1 and norm2 take a centred variance in the fused forward and the
# one-pass one in the module (both in fp32, ~1e-7 relative apart at these
# activations), and the FFN products sum in another order, through 30
# blocks. 1e-4 of max|out|: a TF32 layer (2^-11) would not fit.
NAFNET_FUSED_REL = 1e-4
# One NAFNet forward at 256², card vs CPU, fp32, TF32 off: the convolutions
# in another order (~1e-6 relative per layer, through ~170 layers); the
# same bound, for the same reason.
NAFNET_CARD_VS_CPU_REL = 1e-4

# Backward cases: the training shape first (fp32, as the trainer runs), then
# as the forward's cases. dO is drawn like q, k, v (non-uniform).
BWD_CASES = [
    (2, 4096, 96, torch.float32),
    MAIN,
    (2, 1024, 96, torch.bfloat16),
    (2, 16384, 96, torch.bfloat16),
    (2, 1000, 64, torch.float32),
    (2, 1000, 64, torch.bfloat16),
    (2, 64, 8, torch.float32),
]
# fp32 dX: both sides compute in fp32 from the same inputs and differ only in
# summation order and exp2f against exp (a few ulps per term), so 1e-5 of
# max|dX| leaves a margin of ~10x over what they can differ by (measured
# <= 9.1e-7 of max|dX| on the H100).
BWD_FP32_REL = 1e-5
# bf16 dX: both sides round ds and p^T to bf16 at the same points; they
# differ where an fp32 value sits on a rounding boundary (one bf16 ulp of one
# term of a long sum) and in the final rounding of dX to bf16 (one ulp of
# |dX|). Two bf16 ulps of the largest gradient, 2^-7 * max|dX|, holds both,
# as for the forward's O.
BWD_BF16_REL = 2.0 ** -7
# One training step at 128², fp32 with TF32 off on both devices: convolution
# and matmul sums in another order (~1e-6 relative per op) through ~80
# layers, plus rare flips at the loss's non-smooth points (the eps and x0
# clamps, the L1 sign), each of which moves one pixel's cotangent. Each
# parameter's gradient must agree to 1e-4 of its largest entry (measured
# 3.6-4.0e-6 on the H100, so ~25x of margin, while a layer run at reduced
# precision, TF32 at 2^-11, would not fit under it); that entry is floored
# at 1e-3 of the largest gradient of the model, because the key biases of
# the qkv convs have an exactly zero gradient in exact arithmetic (softmax
# is invariant to a constant shift of every key) and both devices then
# return rounding noise. The losses must agree to 1e-5 relative.
STEP_GRAD_REL = 1e-4
STEP_LOSS_REL = 1e-5
TRAIN_SIZE = 512
TRAIN_PAIRS = 4
VAL_EVALS = 17  # val_inference_steps 15 over 50 noise steps: stride 3, t = 48..0
NAF_TRAIN_PAIRS = 8  # 4 steps at the CLI's batch of 2
NO_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "ln2d": 0, "naf_ffn": 0}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Median device time of one call, from CUDA events around each call, or
    around ``batch`` calls in a row (divided by ``batch``), so that the host's
    time to enqueue a call hides behind the device's work on the one before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def flash_bound(flops: float, nbytes: float, dtype) -> tuple:
    """(bound ms, what bounds it) of a flash kernel: its operations over the
    tensor-core peak of its dtype (fp32: the TF32 peak, the least time any
    unit of the card could take), or its bytes over the HBM rate."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_timings(rows: list) -> dict:
    """The kernels-line keys of the timed flash shapes: the times at the
    fp32 training shape (the one fp32 shape timed), and at every shape."""
    keys = ("n", "dtype", "ms", "ms_batched", "bound_ms", "bound_by", "library_ms",
            "library_ms_batched")
    fp32 = next(r for r in rows if r["dtype"] == "float32")
    return {"fp32": {k: fp32[k] for k in keys[2:] if k in fp32 and k != "bound_by"},
            "timings": [{k: r[k] for k in keys if k in r} for r in rows]}


def check_kernel(report: dict) -> dict:
    """Phase 3: the forward kernel against its plain version, timed at every
    D 96 case (the served sequence lengths in bf16, the training shape in
    fp32) beside SDPA in the same dtype and the bound; returns its
    kernels-line entry (launches filled in by the main paths)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(0)
    rows, timed = [], []
    for bh, n, d, dtype in CASES:
        q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(3))
        o, lse = fa.flash_attention(q, k, v)
        o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        max_o = o_ref.abs().max().item()
        tol_o = BF16_O_REL * max_o if dtype == torch.bfloat16 else TOL_FP32
        err_o = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (err_o <= tol_o and err_lse <= TOL_FP32
              and o.dtype == dtype and lse.dtype == torch.float32)
        row = {"bh": bh, "n": n, "d": d, "dtype": _dt(dtype),
               "max_abs_o": max_o, "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": tol_o, "tol_lse": TOL_FP32, "ok": ok}
        if d == 96:
            q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
            bound, by = flash_bound(4.0 * bh * n * n * d, 4 * bh * n * d * q.element_size() + bh * n * 4, dtype)
            for key, fn in (("ms", lambda: fa.flash_attention(q, k, v)),
                            ("library_ms", lambda: F.scaled_dot_product_attention(q4, k4, v4))):
                row[key] = time_ms(fn)
                row[f"{key}_batched"] = time_ms(fn, batch=FLASH_BATCH)
            row.update({"bound_ms": bound, "bound_by": by})
            timed.append(row)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {row}")
        if (bh, n, d, dtype) == MAIN:
            main_row, main_qkv = row, (q, k, v)
    report["kernel_cases"] = rows

    bh, n, d, _ = MAIN
    qf, kf, vf = (t.float() for t in main_qkv)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "midd_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "midd_tpu/ops/flash_attention.py:51",
        "launches": None,
        "max_abs_err": main_row["max_abs_err_o"],
        "ms": main_row["ms"],
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(qf, kf, vf), reps=10),
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": "scaled_dot_product_attention, same dtype",
        "shape": [bh, n, d],
        "dtype": "bfloat16",
        **flash_timings(timed),
    }


KERNEL_COUNTERS = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
                   "flash_bwd_dkv": fa.flash_bwd_dkv, "ln2d": ln.ln2d, "naf_ffn": ffn.naf_ffn_fused}


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}


def zero_counts() -> None:
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0


def since(before: dict) -> dict:
    return {k: v - before[k] for k, v in counts().items()}


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward on (BH, N, D) operands, dq, dk and dv together: the
    device time under ``torch.profiler`` of the kernels of one forward +
    ``autograd.grad`` less those of one forward (median of 3 each). Events
    around the call would count autograd's host time, which exceeds the
    device's at these shapes."""
    bh, n, d = q.shape
    q4, k4, v4 = (t.view(1, bh, n, d).clone().requires_grad_(True) for t in (q, k, v))
    do4 = do.view(1, bh, n, d)

    def fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4)

    fwd_bwd(), fwd()
    device = lambda fn: statistics.median(sum(device_profile(fn)[0].values()) for _ in range(3))  # noqa: E731
    return device(fwd_bwd) - device(fwd)


def check_bwd(report: dict) -> list:
    """Phase 4: the two backward kernels against their plain versions, each
    timed at every D 96 case beside SDPA's backward in the same dtype and
    its bound; returns their kernels-line entries (launches filled in by the
    main paths)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(1)
    rows, timed = [], {"dq": [], "dkv": []}
    for bh, n, d, dtype in BWD_CASES:
        q, k, v, do = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v)
        delta = fa._delta(o, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        ref_dq = fa.bwd_dq_plain(q, k, v, do, lse, delta)
        ref_dk, ref_dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        rel = BWD_BF16_REL if dtype == torch.bfloat16 else BWD_FP32_REL
        row = {"bh": bh, "n": n, "d": d, "dtype": _dt(dtype), "ok": True}
        for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            max_ref = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            row[name] = {"max_abs": max_ref, "max_abs_err": err, "tol": rel * max_ref}
            row["ok"] &= got.dtype == dtype and got.shape == q.shape and err <= rel * max_ref
        if d == 96:
            calls = {"dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
                     "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta)}
            ms = {key: time_ms(fn) for key, fn in calls.items()}
            ms_batched = {key: time_ms(fn, batch=FLASH_BATCH) for key, fn in calls.items()}
            library_ms = sdpa_bwd_ms(q, k, v, do)
            in_bytes = 4 * bh * n * d * q.element_size() + 2 * bh * n * 4  # q, k, v, dO; lse, delta
            for key, products, outs in (("dq", 3, 1), ("dkv", 4, 2)):
                bound, by = flash_bound(products * 2.0 * bh * n * n * d,
                                        in_bytes + outs * bh * n * d * q.element_size(), dtype)
                timed[key].append({"n": n, "dtype": _dt(dtype), "ms": ms[key],
                                   "ms_batched": ms_batched[key], "bound_ms": bound,
                                   "bound_by": by, "library_ms": library_ms})
            row.update({"ms": ms, "ms_batched": ms_batched})
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"flash backward disagrees with its plain version: {row}")
        if (bh, n, d, dtype) == MAIN:
            main_row, main_in = row, (q, k, v, do, lse, delta)
    report["bwd_cases"] = rows

    bh, n, d, _ = MAIN
    q, k, v, do, lse, delta = main_in
    plain = {"dq": time_ms(lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta), reps=10),
             "dkv": time_ms(lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta), reps=10)}
    entries = []
    for name, line, errs in (
        ("flash_bwd_dq", 98, [main_row["dq"]["max_abs_err"]]),
        ("flash_bwd_dkv", 132, [main_row["dk"]["max_abs_err"], main_row["dv"]["max_abs_err"]]),
    ):
        key = name.split("_")[-1]
        main_t = next(r for r in timed[key] if r["n"] == n and r["dtype"] == "bfloat16")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "midd_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"midd_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(errs),
            "ms": main_t["ms"],
            "plain_ms": plain[key],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "library": "scaled_dot_product_attention backward, same dtype: device time of "
                       "(forward + autograd.grad) - forward under torch.profiler, dq, dk and dv together",
            "shape": [bh, n, d],
            "dtype": "bfloat16",
            **flash_timings(timed[key]),
        })
    return entries


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _kernel_cases():
    """(b, c, h, w, dtype, layout): every SERVE_NAFNET stage of a 512² input
    at batch 1 and 2, and the ragged shape, in fp32 and bf16, NCHW; and at
    batch 1 in channels-last, the layout the engine's and the trainer's
    activations take (cuDNN keeps it from their permuted NHWC inputs)."""
    shapes = [(b, c, s, s, "nchw") for c, s in NAF_STAGES for b in (1, 2)]
    shapes += [(1, c, s, s, "channels_last") for c, s in NAF_STAGES]
    shapes += [(2, *NAF_RAGGED, layout) for layout in ("nchw", "channels_last")]
    return [(*shape[:4], dtype, shape[4]) for shape in shapes for dtype in (torch.float32, torch.bfloat16)]


def _in_layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "channels_last_offset":  # channels-last strides, not 16-byte aligned
        b, c, h, w = x.shape
        flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
        view = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
        view.copy_(x)
        assert view.is_contiguous(memory_format=torch.channels_last) and view.data_ptr() % 16 != 0
        return view
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _isolated_sums(stage_rows: dict, keys: tuple) -> dict:
    """Per layout, the sum over one SERVE_NAFNET forward at 512², batch 1,
    fp32 of a per-call number: each stage's isolated call times its calls
    per forward. Computed, not measured in a forward: there the input was
    just written by the layer before, and the time can differ."""
    return {layout: {k: sum(r[k] * r["calls_per_forward"] for r in rows) for k in keys}
            for layout, rows in stage_rows.items()}


def check_ln2d(report: dict) -> dict:
    """Phase 5: the LayerNorm2d kernel against its plain version; returns its
    kernels-line entry (launches filled in from the main paths)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(2)
    rows, stage_rows = [], {"nchw": [], "channels_last": []}
    cases = [(*case, True) for case in _kernel_cases()] + [(*case, False) for case in LN_EDGE_CASES]
    for b, c, h, w, dtype, layout, timed in cases:
        x = (2.5 + torch.randn(b, c, h, w, generator=gen)).to("cuda", dtype)  # mean 2.5x the spread
        x = _in_layout(x, layout)
        scale = (1 + 0.2 * torch.randn(c, generator=gen)).cuda()
        bias = (0.2 * torch.randn(c, generator=gen)).cuda()
        y = ln.ln2d(x, scale, bias)
        ref = ln.ln2d_plain(x, scale, bias)
        torch.cuda.synchronize()
        max_y = ref.float().abs().max().item()
        tol = (LN_BF16_REL if dtype == torch.bfloat16 else LN_FP32_REL) * max_y
        err = (y.float() - ref.float()).abs().max().item()
        row = {"shape": [b, c, h, w], "dtype": _dt(dtype), "layout": layout, "max_abs_y": max_y,
               "max_abs_err": err, "tol": tol, "bitwise_equal": bool(torch.equal(y, ref)),
               "ok": (err <= tol and y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
                      and (dtype != torch.float32 or c & (c - 1) != 0 or torch.equal(y, ref)))}
        if timed and b == 1:  # the served batch: times, bound and yardstick
            p, elt = b * h * w, x.element_size()
            t_bytes = (2 * p * c * elt + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 8.0 * p * c / PEAK_FP32_FLOPS * 1e3
            xcl = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()  # made once, outside the timing
            sc, bi = scale.to(dtype), bias.to(dtype)
            kernel = lambda: ln.ln2d(x, scale, bias)  # noqa: E731
            library = lambda: F.layer_norm(xcl, (c,), sc, bi, 1e-6)  # noqa: E731
            row.update({
                "ms": time_ms(kernel), "ms_batched": time_ms(kernel, batch=FLASH_BATCH),
                "plain_ms": time_ms(lambda: ln.ln2d_plain(x, scale, bias), reps=5, warmup=1),
                "library_ms": time_ms(library), "library_ms_batched": time_ms(library, batch=FLASH_BATCH),
                # one call's kernels under the profiler: no host time, which
                # sets both timings above at the narrow stages
                "device_ms": sum(device_profile(kernel)[0].values()),
                "library_device_ms": sum(device_profile(library)[0].values()),
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "calls_per_forward": 2 * NAF_BLOCKS.get(c, 0),
            })
            if dtype == torch.float32 and c in NAF_BLOCKS:
                stage_rows[layout].append(row)
        print(json.dumps({"ln2d": row}), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"ln2d disagrees with its plain version: {row}")
    report["ln2d_cases"] = rows
    report["ln2d_sum_of_isolated_calls_per_forward"] = _isolated_sums(
        stage_rows, ("ms", "ms_batched", "device_ms", "plain_ms", "bound_ms", "library_ms",
                     "library_ms_batched", "library_device_ms"))
    # C 32 at 512², batch 1, fp32, channels-last: the largest call, in the
    # layout of the served and trained NAFNet
    main = stage_rows["channels_last"][0]
    return {
        "name": "ln2d", "route": "cuda", "source": "midd_tpu_torch/csrc/ln2d.cu",
        "replaces": "midd_tpu/ops/ln2d.py:66", "replaces_also": "midd_tpu/ops/ln2d.py:102",
        "launches": None, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "F.layer_norm over the last dim of a pre-made (P, C) channels-last copy",
        "shape": main["shape"], "dtype": "float32", "layout": main["layout"],
        "ms_batched": main["ms_batched"], "library_ms_batched": main["library_ms_batched"],
        "device_ms": main["device_ms"], "library_device_ms": main["library_device_ms"],
    }


def _ffn_params(c: int, gen: torch.Generator):
    """norm2 scale and bias, conv4 and conv5 as the port's modules hold them
    (LeCun-normal weights), and gamma: non-trivial values, on the card."""
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    return [t.cuda() for t in (1 + 0.2 * r(c), 0.2 * r(c), r(2 * c, c, 1, 1) * c ** -0.5,
                               0.1 * r(2 * c), r(c, c, 1, 1) * c ** -0.5, 0.1 * r(c), 0.2 * r(1, c, 1, 1))]


def check_naf_ffn(report: dict) -> dict:
    """Phase 6: the fused FFN kernel against its plain version; returns its
    kernels-line entry (launches filled in from the fused forward)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(4)
    rows, stage_rows = [], {"nchw": [], "channels_last": []}
    for b, c, h, w, dtype, layout in _kernel_cases():
        y = _in_layout(torch.randn(b, c, h, w, generator=gen).to("cuda", dtype), layout)
        params = _ffn_params(c, gen)
        out = ffn.naf_ffn_fused(y, *params)
        ref = ffn.naf_ffn_plain(y, *params)
        torch.cuda.synchronize()
        max_out = ref.float().abs().max().item()
        tol = (FFN_BF16_REL if dtype == torch.bfloat16 else FFN_FP32_REL) * max_out
        err = (out.float() - ref.float()).abs().max().item()
        row = {"shape": [b, c, h, w], "dtype": _dt(dtype), "layout": layout, "max_abs_out": max_out,
               "max_abs_err": err, "tol": tol,
               "ok": err <= tol and out.dtype == dtype and out.shape == y.shape and out.stride() == y.stride()}
        if b == 1:
            p, elt = b * h * w, y.element_size()
            # 6 P C^2 for the two products, ~12 P C for the norm, gate, bias and residual
            t_ops = (6.0 * p * c * c + 12.0 * p * c) / PEAK_FP32_FLOPS * 1e3
            t_bytes = (2 * p * c * elt + (3 * c * c + 7 * c) * 4) / HBM_BYTES_PER_S * 1e3
            row.update({
                "ms": time_ms(lambda: ffn.naf_ffn_fused(y, *params)),
                "plain_ms": time_ms(lambda: ffn.naf_ffn_plain(y, *params)),
                "library_ms": None,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "calls_per_forward": NAF_BLOCKS.get(c, 0),
            })
            if dtype == torch.float32 and c in NAF_BLOCKS:
                stage_rows[layout].append(row)
        print(json.dumps({"naf_ffn": row}), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"naf_ffn disagrees with its plain version: {row}")
    report["naf_ffn_cases"] = rows
    report["naf_ffn_sum_of_isolated_calls_per_forward"] = _isolated_sums(
        stage_rows, ("ms", "plain_ms", "bound_ms"))
    main = stage_rows["nchw"][0]  # C 32 at 512², fp32, NCHW: the layout of phase 7's input
    return {
        "name": "naf_ffn", "route": "cuda", "source": "midd_tpu_torch/csrc/naf_ffn.cu",
        "replaces": "midd_tpu/ops/naf_ffn.py:32", "launches": None,
        "max_abs_err": main["max_abs_err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes LayerNorm -> 1x1 -> SimpleGate -> 1x1 -> residual",
        "shape": main["shape"], "dtype": "float32", "layout": main["layout"],
    }


def perturbed_nafnet(seed: int) -> EnhancedNAFNet:
    """SERVE_NAFNET with seeded LeCun-normal convs (``init_weights``) and
    random biases, norm scales and NAFBlock beta/gamma, on the CPU: with the
    initial zero beta and gamma every NAFBlock is the identity."""
    model = init_weights(EnhancedNAFNet(config.SERVE_NAFNET), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "beta", "gamma")):
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
            elif ".norm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return model


def fused_forward(report: dict, profile: bool) -> dict:
    """Phase 7: ``nafnet_apply_fused`` at SERVE_NAFNET, 512², fp32, against the
    module's forward on the card; with ``profile`` (``--report``), the device
    time by kernel kind of one call of each. Returns the launches of the
    fused forward."""
    set_tf32(False)
    model = perturbed_nafnet(7).cuda().eval()
    x = torch.from_numpy(np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 13))), np.float32) / 255)
    x = x[None, None].cuda()
    with torch.inference_mode():
        zero_counts()
        out = nafnet_apply_fused(model, x)
        torch.cuda.synchronize()
        launched = counts()
        ref = model(x)
        res = {"shape": list(out.shape), "max_abs_ref": ref.abs().max().item(),
               "max_abs_err": (out - ref).abs().max().item(), "launches": launched,
               "fused_ms": time_ms(lambda: nafnet_apply_fused(model, x), reps=10),
               "module_ms": time_ms(lambda: model(x), reps=10)}
        if profile:
            res["device_ms_by_kind"] = {"fused": device_profile(lambda: nafnet_apply_fused(model, x))[1],
                                        "module": device_profile(lambda: model(x))[1]}
    res["tol"] = NAFNET_FUSED_REL * res["max_abs_ref"]
    report["nafnet_apply_fused"] = res
    print(json.dumps({"nafnet_apply_fused": res}), flush=True)
    assert launched == {**NO_LAUNCHES, "naf_ffn": 30}, launched
    assert torch.isfinite(out).all() and out.shape == (1, 1, 512, 512)
    assert res["max_abs_err"] <= res["tol"], res
    del model
    torch.cuda.empty_cache()
    return launched


def nafnet_card_vs_cpu(report: dict) -> None:
    """Phase 9b: one fp32 NAFNet forward at 256², card against CPU, same
    perturbed weights and input."""
    set_tf32(False)
    x = torch.from_numpy(np.asarray(Image.open(io.BytesIO(xray_png(256, 256, 17))), np.float32) / 255)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = perturbed_nafnet(11).to(dev).eval()
        with torch.inference_mode():
            zero_counts()
            outs[dev] = model(x[None, None].to(dev)).cpu()
            launched = counts()
        if dev == "cuda":
            card_launches = launched
    diff = (outs["cuda"] - outs["cpu"]).abs().max().item()
    top = outs["cpu"].abs().max().item()
    res = {"max_abs_diff": diff, "max_abs_out": top, "bound": NAFNET_CARD_VS_CPU_REL * top,
           "launches": card_launches}
    report["nafnet_card_vs_cpu"] = res
    print(json.dumps({"nafnet_card_vs_cpu": res}), flush=True)
    assert card_launches == {**NO_LAUNCHES, "ln2d": 60}, card_launches
    assert torch.isfinite(outs["cuda"]).all() and diff <= res["bound"], res


def worst_grad_ratio(g_gpu: dict, g_cpu: dict) -> tuple:
    """The largest card-vs-CPU gradient difference over all parameters, each
    divided by its CPU gradient's largest entry (floored at 1e-3 of the
    model's largest, see STEP_GRAD_REL), and the parameter it occurs in."""
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, None
    for name, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-3 * top)
        ratio = (g_gpu[name] - g).abs().max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def nafnet_step_card_vs_cpu(report: dict) -> None:
    """Phase 10b: one NAFNet training step's loss and gradients on both
    devices (the reference CombinedLoss), and a gradient for every
    LayerNorm2d weight and bias and for the convolutions in front of them."""
    set_tf32(False)
    rng = np.random.default_rng(6)
    clean = np.stack([np.asarray(Image.open(io.BytesIO(xray_png(128, 128, 40 + i))), np.float32) / 255
                      for i in range(2)])[:, None]
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = perturbed_nafnet(23).to(dev)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (clean, noisy))
        zero_counts()
        loss, _ = nafnet_loss_fn("reference")(model, batch, no_draw(batch, None))
        loss.backward()
        launched = counts()
        norms = [n for n, m in model.named_modules() if isinstance(m, LayerNorm2d)]
        out[dev] = (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                    launched, norms)
    (l_gpu, g_gpu, launched, norms), (l_cpu, g_cpu, _, _) = out["cuda"], out["cpu"]
    worst, worst_name = worst_grad_ratio(g_gpu, g_cpu)
    norm_grads = [f"{n}.{k}" for n in norms for k in ("weight", "bias")]
    dead = [n for n in norm_grads + [n for n in g_gpu if n.endswith(("conv1.weight", "conv4.weight"))]
            if not (torch.isfinite(g_gpu[n]).all() and g_gpu[n].abs().max() > 0)]
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_ratio": worst, "worst_param": worst_name, "grad_bound": STEP_GRAD_REL,
           "n_params": len(g_cpu), "norms": len(norms), "params_without_gradient": dead,
           "launches": launched}
    report["nafnet_step_card_vs_cpu"] = res
    print(json.dumps({"nafnet_step_card_vs_cpu": res}), flush=True)
    assert launched == {**NO_LAUNCHES, "ln2d": 60} and len(norms) == 60, (launched, len(norms))
    assert not dead, dead
    assert np.isfinite(l_gpu) and res["loss_rel_diff"] <= STEP_LOSS_REL, res
    assert worst <= STEP_GRAD_REL, res


def train_step_card_vs_cpu(report: dict) -> None:
    """Phase 10a: one diffusion training step's loss and gradients on both
    devices."""
    set_tf32(False)
    size = 128
    rng = np.random.default_rng(5)
    clean = np.asarray(Image.open(io.BytesIO(xray_png(size, size, 11))), np.float32) / 255
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    eps = rng.standard_normal(clean.shape).astype(np.float32)
    t = torch.tensor([23])
    sched = make_schedule(config.SERVE_SCHEDULE)
    ah = sched.alpha_hat[t].item()
    x_t = np.sqrt(ah) * clean + np.sqrt(1 - ah) * eps
    out = {}
    for dev in ("cuda", "cpu"):
        model = init_weights(UNetDiffusion(config.SERVE_DIFFUSION), torch.Generator().manual_seed(0)).to(dev)
        c, nz, e, xt = (torch.from_numpy(np.ascontiguousarray(a, np.float32))[None, None].to(dev)
                        for a in (clean, noisy, eps, x_t))
        zero_counts()
        loss, _ = diffusion_loss_fn(sched.to(dev))(model, (c, nz), (t.to(dev), xt, e))
        loss.backward()
        launched = counts()
        out[dev] = (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}, launched)
    (l_gpu, g_gpu, launched), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    worst, worst_name = worst_grad_ratio(g_gpu, g_cpu)
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_ratio": worst, "worst_param": worst_name, "grad_bound": STEP_GRAD_REL,
           "n_params": len(g_cpu), "launches": launched}
    report["train_step_card_vs_cpu"] = res
    print(json.dumps({"train_step_card_vs_cpu": res}), flush=True)
    assert launched == {**NO_LAUNCHES, "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}, launched
    assert np.isfinite(l_gpu) and res["loss_rel_diff"] <= STEP_LOSS_REL, res
    assert worst <= STEP_GRAD_REL, res


def write_pairs(root: str, n: int, size: int):
    """n seeded synthetic clean/noisy radiograph pairs as PNG files under
    root/clean and root/noisy (same file names)."""
    dirs = [os.path.join(root, "clean"), os.path.join(root, "noisy")]
    for d in dirs:
        os.makedirs(d)
    for i in range(n):
        png = xray_png(size, size, seed=100 + i)
        clean = np.asarray(Image.open(io.BytesIO(png)), np.float32) / 255
        rng = np.random.default_rng(200 + i)
        noisy = np.clip(clean * (1 + 0.2 * rng.standard_normal(clean.shape)), 0, 1)
        with open(os.path.join(dirs[0], f"xray_{i}.png"), "wb") as f:
            f.write(png)
        Image.fromarray((noisy * 255).astype(np.uint8), mode="L").save(
            os.path.join(dirs[1], f"xray_{i}.png"))
    return dirs


@contextlib.contextmanager
def cli_run(model: str, n_pairs: int, *extra: str):
    """``recipes.main --model MODEL`` at 512², 1 epoch, on ``n_pairs`` seeded
    synthetic pairs in a temporary working directory, with every Trainer
    step timed and counted and every validation counted. Yields the run's
    record, the TrainerState and the checkpoint directory (deleted on exit)."""
    # torch's defaults, as a training process runs: fp32 matmuls exact, convs TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    steps, vals = [], []
    orig_step, orig_validate = Trainer.train_step, Trainer.validate

    def timed_step(self, batch):
        before, t0 = counts(), time.perf_counter()
        loss = orig_step(self, batch)  # returns a host float: the step has finished
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss, "launches": since(before)})
        return loss

    def counted_validate(self, samples):
        before = counts()
        out = orig_validate(self, samples)
        vals.append(since(before))
        return out

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        clean_dir, noisy_dir = write_pairs(tmp, n_pairs, TRAIN_SIZE)
        Trainer.train_step, Trainer.validate = timed_step, counted_validate
        os.chdir(tmp)  # the CLI writes checkpoints/ and its curves PNG to the working directory
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            state = recipes.main([
                "--model", model, "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
                "--img-size", str(TRAIN_SIZE), "--epochs", "1", "--max-samples", str(n_pairs), *extra,
            ])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launched = counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
        finally:
            Trainer.train_step, Trainer.validate = orig_step, orig_validate
            os.chdir(cwd)
        step_ms = [st["ms"] for st in steps]
        run = {
            "steps": len(steps), "losses": [st["loss"] for st in steps], "step_ms": step_ms,
            "step_ms_median_after_first": statistics.median(step_ms[1:]),
            "launches_per_step": [st["launches"] for st in steps], "validation_launches": vals,
            "launches": launched, "wall_s": wall_s, "peak_memory_gib": peak_gib,
            "history": state.history,
        }
        yield run, state, os.path.join(tmp, "checkpoints")


def serve_checkpoint(ckpt_dir: str, name: str) -> tuple:
    """An InferenceEngine on a trained checkpoint answers one 512² request;
    returns its launches and the checkpoint's metadata as the engine read it."""
    engine = InferenceEngine(EngineConfig(ckpt_dir=ckpt_dir))
    try:
        meta = engine.meta[name]
        assert "demo_weights" not in meta and meta.get("epoch") == 0, meta
        x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 21))), np.float32)[None, :, :, None] / 255
        zero_counts()
        outs = engine.process_all(x, (512, 512))
        served = counts()
    finally:
        engine.close()
    assert all(outs[n] is not None for n in MODEL_NAMES), [n for n in MODEL_NAMES if outs[n] is None]
    assert served == PER_REQUEST, served
    return served, meta


def moved_tensors(ckpt: dict, fresh: dict) -> int:
    return sum(not torch.equal(fresh[k], v) for k, v in ckpt["model_state_dict"].items())


def train_slice(report: dict, smi: str) -> dict:
    """Phase 11a: the diffusion training CLI at full width, then serving what
    it wrote. Returns the launches of the training run."""
    try:
        import matplotlib
        plotting = matplotlib.__version__
    except ImportError:
        plotting = None
    with cli_run("diffusion", TRAIN_PAIRS, "--batch-size", "1") as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "diffusion.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(UNetDiffusion(config.SERVE_DIFFUSION),
                             torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        res = {"card": smi, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"]), "matplotlib": plotting}
        report["train_slice"] = res
        print(json.dumps({"train_slice": res}), flush=True)
        assert run["steps"] == TRAIN_PAIRS, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        per_step = {**NO_LAUNCHES, "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}
        assert all(n == per_step for n in run["launches_per_step"]), res
        assert run["validation_launches"] == [{**NO_LAUNCHES, "flash_fwd": 6 * VAL_EVALS}], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "in_channels",
                     "model_channels", "channel_mult", "num_res_blocks", "attention_resolutions",
                     "time_emb_dim", "skip_mode", "noise_steps", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["noise_steps"] == config.SERVE_SCHEDULE.noise_steps and ckpt["epoch"] == 0, ckpt["epoch"]

        served, meta = serve_checkpoint(ckpt_dir, "diffusion")
        report["train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "diffusion", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def nafnet_train_slice(report: dict, smi: str) -> dict:
    """Phase 11b: the NAFNet training CLI at full width and its default batch
    of 2, then serving what it wrote. Returns the launches of the training
    run."""
    with cli_run("nafnet", NAF_TRAIN_PAIRS) as (run, state, ckpt_dir):
        ckpt = torch.load(os.path.join(ckpt_dir, "nafnet.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(EnhancedNAFNet(config.SERVE_NAFNET),
                             torch.Generator().manual_seed(42)).state_dict()
        moved = moved_tensors(ckpt, fresh)
        res = {"card": smi, "batch_size": 2, **run, "tensors_moved": moved,
               "tensors": len(ckpt["model_state_dict"])}
        report["nafnet_train_slice"] = res
        print(json.dumps({"nafnet_train_slice": res}), flush=True)
        assert run["steps"] == NAF_TRAIN_PAIRS // 2, res
        assert all(np.isfinite(loss) for loss in run["losses"]), res
        per_forward = {**NO_LAUNCHES, "ln2d": 60}  # the backward recomputes the norms in plain ops
        assert all(n == per_forward for n in run["launches_per_step"]), res
        assert run["validation_launches"] == [per_forward], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "img_channel",
                     "width", "middle_blk_num", "enc_blk_nums", "dec_blk_nums", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["width"] == config.SERVE_NAFNET.width and ckpt["epoch"] == 0, ckpt["epoch"]

        served, meta = serve_checkpoint(ckpt_dir, "nafnet")
        report["nafnet_train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"model": "nafnet", "launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return run["launches"]


def xray_png(width: int, height: int, seed: int) -> bytes:
    """A smooth synthetic radiograph with grain, seeded."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width] / max(width, height)
    img = 0.3 + 0.4 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.08)
    img += 0.05 * rng.standard_normal((height, width))
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def http_json(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def post_denoise(addr, png: bytes, size) -> float:
    """One multipart POST /denoise; checks four non-null PNGs of ``size`` and
    returns the request's wall ms."""
    boundary = "smokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
    body += png + f"\r\n--{boundary}--\r\n".encode()
    t = time.perf_counter()
    status, out = http_json(addr, "POST", "/denoise", body,
                            {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    ms = (time.perf_counter() - t) * 1e3
    assert status == 200, out
    for name in MODEL_NAMES:
        assert out.get(name) is not None, f"path {name} answered null"
        img = Image.open(io.BytesIO(base64.b64decode(out[name])))
        assert img.size == size and img.mode == "L", (name, img.size)
    return ms


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _kind(kernel: str) -> str:
    n = kernel.lower()
    if "ln2d" in n:
        return "ln2d (port kernel)"
    if "naf_ffn" in n:
        return "naf_ffn (port kernel)"
    if "flash_fwd" in n:
        return "flash_fwd (port kernel)"
    if "flash_bwd_dq" in n:
        return "flash_bwd dq (port kernel)"
    if "flash_bwd_dkv" in n:
        return "flash_bwd dk/dv (port kernel)"
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90", "wgrad", "dgrad", "cutlass")):
        return "conv / gemm (cuDNN, cuBLAS)"
    if any(s in n for s in ("norm", "welford", "reduce", "mean")):
        return "norm / reduction"
    if "upsample" in n or "interp" in n:
        return "resize"
    if any(s in n for s in ("memcpy", "memset", "copy")):
        return "copy"
    return "elementwise / other"


def _path_p50_since(engine, marks) -> dict:
    return {n: statistics.median(list(engine.path_ms[n])[marks[n]:]) for n in MODEL_NAMES}


def profile_request(engine, addr) -> dict:
    """``--report`` only: where a 512² request's time goes (see the module
    docstring). Runs after the main path's launch count was read."""
    png = xray_png(512, 512, seed=7)
    x = np.asarray(Image.open(io.BytesIO(png)), np.float32)[None, :, :, None] / 255
    out = {}
    marks = {n: len(engine.path_ms[n]) for n in MODEL_NAMES}
    walls = [post_denoise(addr, png, (512, 512)) for _ in range(PROFILE_REQUESTS)]
    out["http"] = {"wall_ms": walls, "p50_ms": statistics.median(walls),
                   "path_p50_ms": _path_p50_since(engine, marks)}
    marks = {n: len(engine.path_ms[n]) for n in MODEL_NAMES}
    walls = []
    for _ in range(PROFILE_REQUESTS):
        t = time.perf_counter()
        engine.process_all(x, (512, 512))
        walls.append((time.perf_counter() - t) * 1e3)
    out["process_all"] = {"wall_ms": walls, "p50_ms": statistics.median(walls),
                          "path_p50_ms": _path_p50_since(engine, marks)}

    out["paths"] = {}
    for name in MODEL_NAMES:
        fn = engine.fns[name]
        walls = []
        for _ in range(5):
            t = time.perf_counter()
            fn(x)
            walls.append((time.perf_counter() - t) * 1e3)
        before = counts()
        by_kernel, kinds = device_profile(lambda: fn(x))
        launched = since(before)
        wall, device = statistics.median(walls), sum(by_kernel.values())
        out["paths"][name] = {
            "wall_ms": walls, "wall_p50_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall,
            "launches": launched,
            "device_ms_by_kind": kinds,
            "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15],
        }
    wall = sum(p["wall_p50_ms"] for p in out["paths"].values())
    device = sum(p["device_ms"] for p in out["paths"].values())
    out["sum_of_paths"] = {"wall_ms": wall, "device_ms": device, "idle_share": 1.0 - device / wall}

    # the largest GroupNorm input of a 512² UNet eval: 48 channels at full size
    gn = GroupNorm32(8, 48).cuda()
    out["groupnorm_ms"] = {"shape": [1, 48, 512, 512]}
    for dtype in (torch.bfloat16, torch.float32):
        xg = torch.randn(1, 48, 512, 512, device="cuda").to(dtype)
        out["groupnorm_ms"][str(dtype).replace("torch.", "")] = {
            "F.group_norm": time_ms(lambda: F.group_norm(
                xg.float(), 8, gn.weight, gn.bias, gn.eps).to(dtype)),
            "GroupNorm32": time_ms(lambda: gn(xg)),
        }
    out["flash_host_us"] = flash_host_us()
    print(json.dumps({"profile": {"http_p50_ms": out["http"]["p50_ms"],
                                  "process_all_p50_ms": out["process_all"]["p50_ms"],
                                  "sum_of_paths": out["sum_of_paths"],
                                  "groupnorm_ms": out["groupnorm_ms"],
                                  "flash_host_us": out["flash_host_us"]}}), flush=True)
    return out


def flash_host_us(calls: int = 2000) -> dict:
    """``--report`` only: host time per serving call (inference_mode) of the
    forward through ``FlashAttention.apply`` and of ``flash_attention``
    called directly, at a shape small enough that the host, not the kernel,
    sets the pace. Median of 5 loops of ``calls`` calls each, in turns."""
    q = torch.randn(2, 64, 32, device="cuda")
    fns = {"FlashAttention.apply": lambda: fa.FlashAttention.apply(q, q, q),
           "flash_attention": lambda: fa.flash_attention(q, q, q)}
    times = {name: [] for name in fns}
    with torch.inference_mode():
        for _ in range(5):
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e6 / calls)
    return {"shape": [2, 64, 32], **{name: statistics.median(ts) for name, ts in times.items()}}


def _device_ms_by_kernel(prof) -> dict:
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        # a user annotation (e.g. Optimizer.step) spans kernels counted on their own
        if getattr(evt, "is_user_annotation", False):
            continue
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    return by_kernel


def _restore_counts(before: dict) -> None:
    for name, counted in KERNEL_COUNTERS.items():
        counted.launches = before[name]


def device_ms_events(fn) -> tuple:
    """One call of ``fn`` timed by CUDA events while the device is still
    busy with a sleep kernel queued ahead of it, so that the events bracket
    the device's work and not the host's time to enqueue it. Returns (ms,
    hidden): ``hidden`` is whether the sleep was still running when ``fn``
    had been enqueued (the start event not yet reached); if not, the sleep
    is doubled and the call taken again, up to ~0.15 s of sleep, after which
    the time includes host gaps (``fn`` waits for the device, for example).
    Only the first call's launches stay in the counts."""
    after_first, cycles = None, 1 << 20
    while True:
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        after_first = after_first or counts()
        if hidden or cycles >= 1 << 28:
            break
        cycles *= 2
    _restore_counts(after_first)
    return a.elapsed_time(b), hidden


# torch.profiler (CUPTI) on the H100 machine has come back with no device
# kernel at all, at random points of a run, and then stayed so for the rest
# of the process; device_profile then times by events (device_ms_events)
PROFILER = {"profiles": 0, "empty_profiles": 0, "event_fallbacks": 0, "unhidden_fallbacks": 0,
            "off": False}


def device_profile(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``: device ms by kernel, and
    by kernel kind (largest first). A profile that recorded no device kernel
    is taken again, up to 3 times, and the launches of a discarded call are
    taken back from the counts. If all 3 come back empty, the profiler is
    off for the rest of the run, and this and every later call is timed by
    ``device_ms_events`` as one entry, not split by kernel (counted in
    ``PROFILER``)."""
    from torch.profiler import ProfilerActivity, profile

    by_kernel = {}
    for _ in range(0 if PROFILER["off"] else 3):
        before = counts()
        PROFILER["profiles"] += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_kernel = _device_ms_by_kernel(prof)
        if by_kernel:
            break
        PROFILER["empty_profiles"] += 1
        _restore_counts(before)
    if not by_kernel:
        PROFILER["off"] = True
        ms, hidden = device_ms_events(fn)
        PROFILER["event_fallbacks"] += 1
        PROFILER["unhidden_fallbacks"] += not hidden
        how = "host gaps included" if not hidden else "host hidden"
        by_kernel = {f"all kernels: CUDA events after a sleep kernel, {how} (profiler off)": ms}
        return by_kernel, {"not split: profiler off": ms}
    kinds = {}
    for k, ms in by_kernel.items():
        kinds[_kind(k)] = kinds.get(_kind(k), 0.0) + ms
    return by_kernel, dict(sorted(kinds.items(), key=lambda kv: -kv[1]))


def profile_train_step(model: str) -> dict:
    """``--report`` only: where a full-width training step's time goes. One
    Trainer step at 512², fp32 (torch's TF32 defaults, as the CLI runs), at
    the CLI's defaults: SERVE_DIFFUSION at batch 1, or SERVE_NAFNET (the
    reference CombinedLoss) at batch 2, on a batch made as the CLI makes
    its batches (``to_device`` of NHWC arrays, so the activations are
    channels-last). Wall time (median of 5 after 2 warm-up steps) beside
    the device time of one further step under ``torch.profiler``, by kernel
    kind."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 31))), np.float32) / 255
    cfg = recipes.default_train_config(model)
    gen = torch.Generator().manual_seed(0)
    if model == "diffusion":
        sched = make_schedule(config.SERVE_SCHEDULE, "cuda")
        trainer = Trainer(diffusion_loss_fn(sched), None, cfg,
                          init_weights(UNetDiffusion(config.SERVE_DIFFUSION), gen),
                          diffusion_draw(sched), device="cuda")
    else:
        trainer = Trainer(nafnet_loss_fn(), None, cfg, perturbed_nafnet(0), no_draw, device="cuda")
    nhwc = np.broadcast_to(x[None, :, :, None], (cfg.batch_size, *x.shape, 1))
    batch = to_device((nhwc, 0.9 * nhwc), torch.device("cuda"))
    for _ in range(2):
        trainer.train_step(batch)
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        trainer.train_step(batch)  # returns a host float: the step has finished
        walls.append((time.perf_counter() - t) * 1e3)
    zero_counts()
    by_kernel, kinds = device_profile(lambda: trainer.train_step(batch))
    launched = counts()
    wall, device = statistics.median(walls), sum(by_kernel.values())
    out = {"model": model, "batch_size": cfg.batch_size, "wall_ms": walls, "wall_p50_ms": wall,
           "device_ms": device, "idle_share": 1.0 - device / wall, "launches": launched,
           "device_ms_by_kind": kinds,
           "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]}
    print(json.dumps({"train_step_profile": {k: out[k] for k in
                                             ("model", "wall_p50_ms", "device_ms", "idle_share",
                                              "device_ms_by_kind")}}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def serve_slice(report: dict, profile: bool) -> dict:
    """Phase 8: full-width serving through the port's server; returns the
    kernel launches of the requests."""
    # torch's defaults, as a served process runs: fp32 matmuls exact, convs TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t = time.time()
    engine = InferenceEngine(EngineConfig())
    report["engine_build_s"] = time.time() - t
    mode = engine.serving_mode()
    assert mode["img_size"] == 512 and mode["steps"] == [8, 8], mode
    assert mode["diffusion_eps"] == [0, 2, 6, 7] and mode["hybrid_eps"] == [0, 2, 6, 7], mode
    srv = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    try:
        status, body = http_json(addr, "GET", "/")
        assert status == 200 and body["status"] == "running", body
        status, body = http_json(addr, "GET", "/health")
        assert status == 200 and body["models_loaded"] == {n: True for n in MODEL_NAMES}, body
        print(json.dumps({"health": body}), flush=True)

        sizes = [(600, 500), (512, 512), (333, 421)]
        latencies, per_request = [], []
        zero_counts()
        for i, size in enumerate(sizes):
            before = counts()
            latencies.append(post_denoise(addr, xray_png(*size, seed=i), size))
            per_request.append(since(before))
            assert per_request[-1] == PER_REQUEST, f"request {i}: {per_request[-1]} launches"
        launches = counts()
        report["path_ms"] = {n: list(engine.path_ms[n]) for n in MODEL_NAMES}
        if profile:
            report["profile"] = profile_request(engine, addr)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 9))), np.float32)[None, :, :, None] / 255
    for name in MODEL_NAMES:
        y = engine.fns[name](x)
        assert y.shape == (1, 512, 512, 1) and np.isfinite(y).all(), name
        assert y.min() >= 0.0 and y.max() <= 1.0, name
    report["request_ms"] = latencies
    report["request_p50_ms"] = statistics.median(latencies)
    report["launches_per_request"] = per_request
    print(json.dumps({"request_ms": latencies, "request_p50_ms": report["request_p50_ms"],
                      "path_ms": report["path_ms"],
                      "launches_per_request": per_request}), flush=True)
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return launches


def card_vs_cpu(report: dict) -> None:
    """Phase 9a: one exact fp32 diffusion rollout at 256² on the card and on
    the CPU, same seeded demo weights and input."""
    set_tf32(False)
    kw = dict(img_size=256, warmup=False, turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1,
              diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
    x = np.asarray(Image.open(io.BytesIO(xray_png(256, 256, 3))), np.float32)[None, :, :, None] / 255
    before = fa.flash_attention.launches
    gpu = InferenceEngine(EngineConfig(**kw, device="cuda")).fns["diffusion"](x)
    launches = fa.flash_attention.launches - before
    cpu = InferenceEngine(EngineConfig(**kw, device="cpu")).fns["diffusion"](x)
    diff = float(np.abs(gpu - cpu).max())
    report["card_vs_cpu"] = {"max_abs_diff": diff, "bound": CARD_VS_CPU_BOUND,
                             "flash_launches": launches}
    print(json.dumps({"card_vs_cpu": report["card_vs_cpu"]}), flush=True)
    assert np.isfinite(gpu).all() and gpu.shape == (1, 256, 256, 1)
    assert launches == 9 * 6, launches
    assert diff <= CARD_VS_CPU_BOUND, f"card vs CPU rollout differs by {diff}"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None,
                    help="also profile a request and a training step and write a JSON report here")
    args = ap.parse_args(argv)
    t_all = time.time()
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}

    phase("build")
    t = time.time()
    libraries = {fa.SOURCE: fa._SIGNATURES[fa.SOURCE], fa.BWD_SOURCE: fa._SIGNATURES[fa.BWD_SOURCE],
                 ln.SOURCE: ln._SIGNATURES, ffn.SOURCE: ffn._SIGNATURES}
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:  # one nvcc per source, all at once
        for lib in pool.map(lambda src: _build.build(src, verbose=True), libraries):
            print(lib, flush=True)
    for source, signatures in libraries.items():
        _build.library(source, signatures)
    report["build_s"] = time.time() - t
    print(json.dumps({"build_s": report["build_s"]}), flush=True)

    phase("forward kernel vs plain")
    entries = [check_kernel(report)]

    phase("backward kernels vs plain")
    entries += check_bwd(report)

    phase("ln2d kernel vs plain")
    entries.append(check_ln2d(report))

    phase("naf_ffn kernel vs plain")
    entries.append(check_naf_ffn(report))

    # the main paths, each driven with the counts set to 0 just before it
    paths = {}
    phase("slice: nafnet_apply_fused at 512²")
    paths["nafnet_apply_fused"] = fused_forward(report, profile=args.report is not None)

    phase("slice: 512² /denoise through the port's server")
    paths["serve"] = serve_slice(report, profile=args.report is not None)

    phase("card vs CPU")
    card_vs_cpu(report)
    nafnet_card_vs_cpu(report)

    phase("one training step, card vs CPU")
    train_step_card_vs_cpu(report)
    nafnet_step_card_vs_cpu(report)

    phase("slice: training through recipes.main at 512², then serving its checkpoint")
    paths["train_diffusion"] = train_slice(report, smi)
    paths["train_nafnet"] = nafnet_train_slice(report, smi)
    if args.report:
        report["train_step_profile"] = profile_train_step("diffusion")
        report["nafnet_train_step_profile"] = profile_train_step("nafnet")

    for entry in entries:
        by_path = {p: launched[entry["name"]] for p, launched in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was never launched on the main paths")
    report["kernels"] = entries
    report["total_s"] = time.time() - t_all
    report["profiler"] = {k: v for k, v in PROFILER.items() if k != "off"}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"total_s": report["total_s"], "profiler": report["profiler"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
