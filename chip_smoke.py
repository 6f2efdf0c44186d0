"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels from this checkout and holds each against its plain PyTorch version,
serves full-width 512² /denoise requests through the port's HTTP server,
trains the full-width diffusion UNet through the port's training CLI and
serves the checkpoint it wrote, and checks the card against the CPU on one
exact rollout and on one training step.

    python3 chip_smoke.py [--report FILE]

Phases (any failure exits non-zero, and no result line is printed):
1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles csrc/flash_fwd.cu and csrc/flash_bwd.cu with nvcc, the two
   at once;
3. forward kernel vs plain: flash_attention against flash_attention_plain
   (TF32 off) at the served shapes, with timings and the SDPA yardstick;
4. backward kernels vs plain: flash_bwd_dq and flash_bwd_dkv against their
   plain versions (TF32 off), with timings and SDPA's backward as yardstick;
5. serving slice: InferenceEngine(EngineConfig()) at 512² with seeded demo
   weights behind the stdlib server; 3 multipart requests, four non-null
   PNGs each, exactly 48 forward and no backward launches per request;
6. card vs CPU: one exact fp32 diffusion rollout at 256² on both devices;
7. one training step, card vs CPU: SERVE_DIFFUSION at 128², fp32, TF32 off,
   same weights, batch and (t, eps); loss and every parameter gradient
   compared; 6 forward, 6 dq and 6 dk/dv launches;
8. training slice: ``recipes.main`` (--model diffusion, 512², 1 epoch, 4
   seeded synthetic pairs, batch 1) = 4 train steps of 6/6/6 launches and a
   validation rollout of 17 evals (102 forward launches); finite losses,
   moved parameters, a diffusion.pth with its metadata; then an
   InferenceEngine on that checkpoint answers one 512² request.
The second-to-last line is the kernels JSON, the last {"ok": true, ...}.

``--report FILE`` also measures where a request's and a training step's time
goes and writes a longer JSON report to FILE: every request and path time, 6
more HTTP requests and 6 in-process ``process_all`` calls, each path's wall
time (median of 5) beside its device time under ``torch.profiler`` (by kernel
kind, top kernels, idle share = 1 - device / wall), ``F.group_norm`` against
the port's ``GroupNorm32`` at the largest GroupNorm input of a 512² UNet
eval, the host time per serving call of the flash forward through its
autograd Function against a direct call, and the same wall/device breakdown
for one 512² training step.
"""

from __future__ import annotations

import base64
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
from midd_tpu_torch.models.blocks import GroupNorm32, init_weights
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops import flash_attention as fa
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.serve.server import make_server
from midd_tpu_torch.train import recipes
from midd_tpu_torch.train.trainer import Trainer, diffusion_draw, diffusion_loss_fn

# H100 SXM data sheet (dense): bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# (bh, n, d, dtype). The plain version runs in fp32 on the same (for bf16:
# bf16-rounded) inputs, with TF32 off.
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
LAUNCHES_PER_REQUEST = 48  # (4 diffusion + 4 hybrid UNet evals) x 6 attention blocks
CARD_VS_CPU_BOUND = 1e-3

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


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def check_kernel(report: dict) -> dict:
    """Phase 3: the forward kernel against its plain version; returns its
    kernels-line entry (launches filled in by phases 5 and 8)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(0)
    rows = []
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
        row = {"bh": bh, "n": n, "d": d, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_o": max_o, "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": tol_o, "tol_lse": TOL_FP32, "ok": ok}
        if d == 96:
            row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v))
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {row}")
        if (bh, n, d, dtype) == MAIN:
            main_row, main_qkv = row, (q, k, v)
    report["kernel_cases"] = rows

    bh, n, d, _ = MAIN
    q, k, v = main_qkv
    qf, kf, vf = q.float(), k.float(), v.float()
    plain_ms = time_ms(lambda: fa.flash_attention_plain(qf, kf, vf), reps=10)
    q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    flops = 4.0 * bh * n * n * d
    nbytes = 4 * bh * n * d * q.element_size() + bh * n * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "midd_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "midd_tpu/ops/flash_attention.py:51",
        "launches": None,
        "max_abs_err": main_row["max_abs_err_o"],
        "ms": main_row["ms"],
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": [bh, n, d],
        "dtype": "bfloat16",
    }
    return entry


KERNEL_COUNTERS = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
                   "flash_bwd_dkv": fa.flash_bwd_dkv}


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}


def zero_counts() -> None:
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0


def since(before: dict) -> dict:
    return {k: v - before[k] for k, v in counts().items()}


def check_bwd(report: dict) -> list:
    """Phase 4: the two backward kernels against their plain versions;
    returns their kernels-line entries (launches filled in by phase 8)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(1)
    rows = []
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
        row = {"bh": bh, "n": n, "d": d, "dtype": str(dtype).replace("torch.", ""), "ok": True}
        for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            max_ref = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            row[name] = {"max_abs": max_ref, "max_abs_err": err, "tol": rel * max_ref}
            row["ok"] &= got.dtype == dtype and got.shape == q.shape and err <= rel * max_ref
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"flash backward disagrees with its plain version: {row}")
        if (bh, n, d, dtype) == MAIN:
            main_row, main_in = row, (q, k, v, do, lse, delta)
    report["bwd_cases"] = rows

    bh, n, d, _ = MAIN
    q, k, v, do, lse, delta = main_in
    ms = {"dq": time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta)),
          "dkv": time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta))}
    plain = {"dq": time_ms(lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta), reps=10),
             "dkv": time_ms(lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta), reps=10)}
    q4, k4, v4 = (t.view(1, bh, n, d).clone().requires_grad_(True) for t in (q, k, v))
    do4 = do.view(1, bh, n, d)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q4, k4, v4)
        torch.autograd.grad(out, (q4, k4, v4), do4)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4)

    library_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
    elt = q.element_size()
    in_bytes = 4 * bh * n * d * elt + 2 * bh * n * 4  # q, k, v, dO; lse, delta
    entries = []
    for name, line, products, outs, errs in (
        ("flash_bwd_dq", 98, 3, 1, [main_row["dq"]["max_abs_err"]]),
        ("flash_bwd_dkv", 132, 4, 2, [main_row["dk"]["max_abs_err"], main_row["dv"]["max_abs_err"]]),
    ):
        t_ops = products * 2.0 * bh * n * n * d / PEAK_BF16_FLOPS * 1e3
        t_bytes = (in_bytes + outs * bh * n * d * elt) / HBM_BYTES_PER_S * 1e3
        key = name.split("_")[-1]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "midd_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"midd_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(errs),
            "ms": ms[key],
            "plain_ms": plain[key],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward: (forward + autograd.grad) "
                       "- forward, dq, dk and dv together",
            "shape": [bh, n, d],
            "dtype": "bfloat16",
        })
    return entries


def train_step_card_vs_cpu(report: dict) -> None:
    """Phase 7: one training step's loss and gradients on both devices."""
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
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, None
    for name, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-3 * top)
        ratio = (g_gpu[name] - g).abs().max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, name
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
           "worst_grad_ratio": worst, "worst_param": worst_name, "grad_bound": STEP_GRAD_REL,
           "n_params": len(g_cpu), "launches": launched}
    report["train_step_card_vs_cpu"] = res
    print(json.dumps({"train_step_card_vs_cpu": res}), flush=True)
    assert launched == {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}, launched
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


def train_slice(report: dict, smi: str) -> dict:
    """Phase 8: the port's training CLI at full width, then serving what it
    wrote. Returns the launches of the training run."""
    # torch's defaults, as a training process runs: fp32 matmuls exact, convs TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        import matplotlib
        plotting = matplotlib.__version__
    except ImportError:
        plotting = None
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
        clean_dir, noisy_dir = write_pairs(tmp, TRAIN_PAIRS, TRAIN_SIZE)
        Trainer.train_step, Trainer.validate = timed_step, counted_validate
        os.chdir(tmp)  # the CLI writes checkpoints/ and its curves PNG to the working directory
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            state = recipes.main([
                "--model", "diffusion", "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
                "--img-size", str(TRAIN_SIZE), "--epochs", "1", "--max-samples", str(TRAIN_PAIRS),
                "--batch-size", "1",
            ])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launched = counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
        finally:
            Trainer.train_step, Trainer.validate = orig_step, orig_validate
            os.chdir(cwd)

        ckpt_dir = os.path.join(tmp, "checkpoints")
        ckpt = torch.load(os.path.join(ckpt_dir, "diffusion.pth"), map_location="cpu", weights_only=True)
        fresh = init_weights(UNetDiffusion(config.SERVE_DIFFUSION),
                             torch.Generator().manual_seed(42)).state_dict()
        moved = sum(not torch.equal(fresh[k], v) for k, v in ckpt["model_state_dict"].items())
        step_ms = [s["ms"] for s in steps]
        res = {
            "card": smi, "steps": len(steps), "losses": [s["loss"] for s in steps],
            "step_ms": step_ms, "step_ms_median_after_first": statistics.median(step_ms[1:]),
            "launches_per_step": [s["launches"] for s in steps], "validation_launches": vals,
            "launches": launched, "wall_s": wall_s, "peak_memory_gib": peak_gib,
            "history": state.history, "tensors_moved": moved,
            "tensors": len(ckpt["model_state_dict"]), "matplotlib": plotting,
        }
        report["train_slice"] = res
        print(json.dumps({"train_slice": res}), flush=True)
        assert len(steps) == TRAIN_PAIRS, res
        assert all(np.isfinite(s["loss"]) for s in steps), res
        per_step = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}
        assert all(s["launches"] == per_step for s in steps), res
        assert vals == [{"flash_fwd": 6 * VAL_EVALS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}], res
        assert moved >= 0.9 * len(fresh), res
        meta_keys = {"epoch", "best_psnr", "best_ssim", "losses", "psnrs", "ssims", "in_channels",
                     "model_channels", "channel_mult", "num_res_blocks", "attention_resolutions",
                     "time_emb_dim", "skip_mode", "noise_steps", "optimizer_state_dict"}
        assert meta_keys <= set(ckpt), sorted(ckpt)
        assert ckpt["noise_steps"] == config.SERVE_SCHEDULE.noise_steps and ckpt["epoch"] == 0, ckpt["epoch"]

        engine = InferenceEngine(EngineConfig(ckpt_dir=ckpt_dir))
        try:
            meta = engine.meta["diffusion"]
            assert "demo_weights" not in meta and meta.get("epoch") == 0, meta
            x = np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 21))), np.float32)[None, :, :, None] / 255
            zero_counts()
            outs = engine.process_all(x, (512, 512))
            served = counts()
        finally:
            engine.close()
        assert all(outs[n] is not None for n in MODEL_NAMES), [n for n in MODEL_NAMES if outs[n] is None]
        assert served == {"flash_fwd": LAUNCHES_PER_REQUEST, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, served
        report["train_slice"]["served_launches"] = served
        print(json.dumps({"served_trained_checkpoint": {"launches": served,
                                                        "meta_epoch": meta["epoch"]}}), flush=True)
    torch.cuda.empty_cache()
    return launched


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
    if "flash_fwd" in n:
        return "flash_fwd (port kernel)"
    if "flash_bwd" in n:
        return "flash_bwd dq + dk/dv (port kernels)"
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
    from torch.profiler import ProfilerActivity, profile

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
        before = fa.flash_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        by_kernel = _device_ms_by_kernel(prof)
        kinds = {}
        for k, ms in by_kernel.items():
            kinds[_kind(k)] = kinds.get(_kind(k), 0.0) + ms
        wall, device = statistics.median(walls), sum(by_kernel.values())
        out["paths"][name] = {
            "wall_ms": walls, "wall_p50_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall,
            "flash_launches": fa.flash_attention.launches - before,
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
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
    assert by_kernel, "the profiler recorded no device kernels"
    return by_kernel


def profile_train_step() -> dict:
    """``--report`` only: where a full-width training step's time goes. One
    Trainer step of SERVE_DIFFUSION at 512², batch 1, fp32 (torch's TF32
    defaults, as the CLI runs): wall time (median of 5 after 2 warm-up
    steps) beside the device time of one further step under
    ``torch.profiler``, by kernel kind."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    sched = make_schedule(config.SERVE_SCHEDULE, "cuda")
    trainer = Trainer(diffusion_loss_fn(sched), None, recipes.default_train_config(),
                      init_weights(UNetDiffusion(config.SERVE_DIFFUSION), torch.Generator().manual_seed(0)),
                      diffusion_draw(sched), device="cuda")
    x = torch.from_numpy(np.asarray(Image.open(io.BytesIO(xray_png(512, 512, 31))), np.float32) / 255)
    batch = (x[None, None].cuda(), (0.9 * x)[None, None].cuda())
    for _ in range(2):
        trainer.train_step(batch)
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        trainer.train_step(batch)  # returns a host float: the step has finished
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    by_kernel = _device_ms_by_kernel(prof)
    kinds = {}
    for k, ms in by_kernel.items():
        kinds[_kind(k)] = kinds.get(_kind(k), 0.0) + ms
    wall, device = statistics.median(walls), sum(by_kernel.values())
    out = {"wall_ms": walls, "wall_p50_ms": wall, "device_ms": device, "idle_share": 1.0 - device / wall,
           "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
           "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]}
    print(json.dumps({"train_step_profile": {k: out[k] for k in
                                             ("wall_p50_ms", "device_ms", "idle_share", "device_ms_by_kind")}}),
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def serve_slice(report: dict, profile: bool) -> dict:
    """Phase 5: full-width serving through the port's server; returns the
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
            want = {"flash_fwd": LAUNCHES_PER_REQUEST, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            assert per_request[-1] == want, f"request {i}: {per_request[-1]} launches"
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
    """Phase 6: one exact fp32 diffusion rollout at 256² on the card and on
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
                    help="also profile a request and write a JSON report here")
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
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, both at once
        for lib in pool.map(lambda src: fa.build(src, verbose=True), (fa.SOURCE, fa.BWD_SOURCE)):
            print(lib, flush=True)
    fa._library(fa.SOURCE)
    fa._library(fa.BWD_SOURCE)
    report["build_s"] = time.time() - t
    print(json.dumps({"build_s": report["build_s"]}), flush=True)

    phase("forward kernel vs plain")
    entries = [check_kernel(report)]

    phase("backward kernels vs plain")
    entries += check_bwd(report)

    phase("slice: 512² /denoise through the port's server")
    served = serve_slice(report, profile=args.report is not None)

    phase("card vs CPU")
    card_vs_cpu(report)

    phase("one training step, card vs CPU")
    train_step_card_vs_cpu(report)

    phase("slice: training through recipes.main at 512², then serving its checkpoint")
    trained = train_slice(report, smi)
    if args.report:
        report["train_step_profile"] = profile_train_step()

    for entry in entries:
        by_path = {"serve": served[entry["name"]], "train": trained[entry["name"]]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was never launched on the main paths")
    report["kernels"] = entries
    report["total_s"] = time.time() - t_all
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"total_s": report["total_s"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
