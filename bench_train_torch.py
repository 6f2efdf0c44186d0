"""Training benchmark of the PyTorch port: ms per step and model-FLOP MFU of
the diffusion and NAFNet recipes on one card (the counterpart of
``bench_train.py``; it imports nothing of JAX or of ``midd_tpu``).

What it measures, per (model, img_size, batch):
- ms per step of the port's real training step: the trainer's loss function
  (``diffusion_loss_fn`` with its draws, ``nafnet_loss_fn``), AdamW from
  ``make_optimizer`` behind the global-norm clip, through
  ``parallel.train_dp.make_sharded_train_step`` as the ``Trainer`` runs it.
  Compute is bf16 (the models' ``compute_dtype``, as the JAX bench's
  ``dtype=bfloat16`` models); parameters and AdamW stay fp32. The first
  call is untimed; then ``--inner`` steps run between two
  ``torch.cuda.synchronize()`` and the best of ``--reps`` is kept. On the
  card the flash forward, dq and dk/dv kernels (diffusion) and ln2d
  (NAFNet) run in the timed step.
- model FLOPs of forward + backward (``midd_tpu_torch/utils/flops.py``) on
  the canonical plain layout, ``UNetDiffusion(fuse_updown=False,
  use_flash=False)``: the exact attention computes the products that the
  flash kernels fuse, and the fused up/down convolution computes fewer
  than the canonical model. (``bench_train.py`` counts its diffusion model
  in the JAX default layout, with space-to-depth stage 0 and fused up/down:
  +34% at 256², batch 2, multiplied structural zeros; the port counts the
  plain one, the layout ``bench.py`` calls canonical.) MFU is that count
  over the step time and ``device_peak_tflops`` (989 TFLOP/s bf16 dense
  for an H100 SXM; ``--peak-tflops`` for any other device, which has no
  entry there).
- the padded figure: every GEMM dimension rounded up to a tile
  (``--pad-tile SUB,LANE``: M to SUB, K and N to LANE; the count's
  ``lane_pad``). The default (64, 16) is Hopper's: ``wgmma.mma_async``
  issues M in steps of 64 rows (one warp group), and a bf16 product
  contracts K 16 at a time; N steps by 8 up to 256, so rounding N to 16 is
  a little coarse. The TPU's (8, 128) pads the narrow channels of these
  models far more than Hopper does.

Also:
- remat on/off at 512², batch 2 (``rematerialise``, the step
  ``TrainConfig.remat`` builds), where the grid has that cell;
- input-pipeline occupancy: ``SyntheticPairedDataset`` over ``make_phantoms``
  -> ``batches(num_workers=2)`` -> ``prefetch_to_device(size=2)`` driving one
  step per batch; occupancy = the step's ms / the wall ms a step of that
  loop (~1.0: the pipeline hides behind the step).

Prints ONE JSON line on stdout (with the card's name and power limit from
``nvidia-smi``); diagnostics on stderr. ``--json-out FILE`` also writes it
to FILE (no file by default; ``bench_train.json`` is the TPU record).

    python bench_train_torch.py [--quick] [--models diffusion,nafnet]
        [--device cuda|cpu] [--inner 8] [--reps 3] [--pad-tile 64,16]

``--models nafnet_s2d`` raises: the space-to-depth layouts are TPU lane
restructurings that the port does not carry, on purpose.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from midd_tpu_torch import config
from midd_tpu_torch.benchmarks.xray_bench import make_phantoms
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.parallel.train_dp import make_sharded_train_step
from midd_tpu_torch.train.data import SyntheticPairedDataset, batches, prefetch_to_device
from midd_tpu_torch.train.trainer import (
    TrainConfig,
    diffusion_draw,
    diffusion_loss_fn,
    make_optimizer,
    nafnet_loss_fn,
    no_draw,
    rematerialise,
)
from midd_tpu_torch.utils.flops import FlopCounter, device_peak_tflops, mfu

# bench_train.py's grid without its nafnet_s2d rows (not ported, on purpose)
GRID = {
    "diffusion": [(256, 2), (256, 4), (256, 8), (256, 16), (512, 2), (512, 4)],
    "nafnet": [(256, 2), (256, 4), (256, 8), (256, 16), (512, 2), (512, 4)],
}
QUICK = {"diffusion": [(256, 2)], "nafnet": [(256, 2)]}
MODELS = tuple(GRID)
MODEL_CFGS = {"diffusion": config.SERVE_DIFFUSION, "nafnet": config.SERVE_NAFNET}
PIPELINE_CELL = (256, 2)  # (img, batch) of the pipeline rows, the recipes' operating point
PIPELINE_IMGS = 64  # phantoms in the pipeline's dataset
S2D_MESSAGE = ("nafnet_s2d: the space-to-depth layouts (the JAX package's ops/naf_s2d.py and "
               "ops/unet_s2d.py) are TPU lane restructurings of the same function and are not "
               "ported, on purpose; benchmark 'nafnet'")
DEFAULT_PAD_TILE = (64, 16)
WARMUP_BATCHES = 4  # the pipeline's untimed batches before its timed epoch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def build(model_kind: str, device: torch.device, seed: int = 0, **kw) -> torch.nn.Module:
    """The fp32 model of ``model_kind`` (at ``MODEL_CFGS``' widths) with
    seeded weights, computing in bf16."""
    model = (UNetDiffusion(MODEL_CFGS[model_kind], **kw) if model_kind == "diffusion"
             else EnhancedNAFNet(MODEL_CFGS[model_kind]))
    init_weights(model, torch.Generator().manual_seed(seed))
    model.compute_dtype = torch.bfloat16
    return model.to(device)


def loss_and_draw(model_kind: str) -> Tuple[Callable, Callable]:
    """The trainer's (loss_fn, draw_fn) of ``model_kind``'s recipe."""
    if model_kind == "diffusion":
        schedule = make_schedule(config.SERVE_SCHEDULE)
        return diffusion_loss_fn(schedule), diffusion_draw(schedule)
    return nafnet_loss_fn(), no_draw


def make_step(model_kind: str, device: torch.device, remat: bool = False, seed: int = 0) -> Callable:
    """``step(clean, noisy) -> loss``, the port's training step: it draws
    (diffusion: t and eps from a seeded generator on the device), runs the
    loss and its backward, clips and applies AdamW."""
    model = build(model_kind, device, seed)
    loss_fn, draw_fn = loss_and_draw(model_kind)
    optimizer = make_optimizer(TrainConfig(lr=2e-4, weight_decay=1e-4), model.parameters())
    train_step = make_sharded_train_step(rematerialise(loss_fn) if remat else loss_fn, optimizer, model,
                                         None, grad_clip=1.0)
    generator = torch.Generator(device=device).manual_seed(seed + 1)

    def step(clean: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
        batch = (clean, noisy)
        return train_step(batch, draw_fn(batch, generator))

    return step


def step_flops(model_kind: str, img: int, batch: int, device: torch.device,
               pad_tile: Tuple[int, int]) -> Tuple[int, int]:
    """(model FLOPs, padded FLOPs) of one training step's forward and
    backward, counted on the plain layout with the exact attention."""
    kw = {"fuse_updown": False, "use_flash": False} if model_kind == "diffusion" else {}
    model = build(model_kind, device, **kw)
    loss_fn, draw_fn = loss_and_draw(model_kind)
    clean = torch.zeros(batch, 1, img, img, device=device)
    draw = draw_fn((clean, clean), torch.Generator(device=device).manual_seed(0))

    with FlopCounter() as exact, FlopCounter(pad_tile) as padded:  # both see every operator of one run
        loss, _ = loss_fn(model, (clean, clean), draw)
        loss.backward()
    return exact.total, padded.total


def _batch_stack(seed: int, n: int, batch: int, img: int, device: torch.device):
    r = np.random.default_rng(seed)
    clean = np.clip(r.random((n, batch, 1, img, img)), 0, 1).astype(np.float32)
    noisy = np.clip(clean + r.normal(0, 0.1, clean.shape), 0, 1).astype(np.float32)
    return torch.from_numpy(clean).to(device), torch.from_numpy(noisy).to(device)


def time_step(model_kind: str, img: int, batch: int, device: torch.device, remat: bool = False,
              inner: int = 8, reps: int = 3) -> float:
    """Seconds a step: the best of ``reps`` runs of ``inner`` steps on
    seeded batches already on the device, after one untimed step."""
    step = make_step(model_kind, device, remat)
    c, n = _batch_stack(1, 1, batch, img, device)
    t = time.time()
    float(step(c[0], n[0]))
    log(f"  first step {time.time() - t:.2f}s")
    best = float("inf")
    for rep in range(reps):
        c, n = _batch_stack(100 + rep, inner, batch, img, device)
        _sync(device)
        t = time.perf_counter()
        for i in range(inner):
            step(c[i], n[i])
        _sync(device)
        best = min(best, (time.perf_counter() - t) / inner)
    return best


def pipeline_occupancy(model_kind: str, img: int, batch: int, step_ms: float,
                       device: torch.device) -> Tuple[float, float]:
    """(occupancy, wall ms a step) of the real input pipeline driving the
    step: host noise synthesis and augmentation on two threads, batches
    copied ahead by the prefetch thread, one step per batch. The first
    ``WARMUP_BATCHES`` batches of an epoch warm up (the step's first call,
    the loader's threads; eager PyTorch compiles nothing, where the JAX
    bench spends an epoch on its compile); a whole epoch is timed."""
    step = make_step(model_kind, device)
    ds = SyntheticPairedDataset(make_phantoms(PIPELINE_IMGS, img, seed=5), noise_type="gaussian", seed=0)

    def epoch(limit: Optional[int] = None) -> int:
        count, loss = 0, None
        for clean, noisy in prefetch_to_device(batches(ds, batch, shuffle=True, seed=1, num_workers=2),
                                               device, size=2):
            loss = step(clean, noisy)
            count += 1
            if count == limit:
                break
        float(loss)
        return count

    epoch(WARMUP_BATCHES)
    t = time.perf_counter()
    steps = epoch()
    wall_ms = (time.perf_counter() - t) / steps * 1e3
    return step_ms / wall_ms, wall_ms


def parse_tile(text: str) -> Tuple[int, int]:
    sub, lane = (int(v) for v in text.split(","))
    return sub, lane


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true", help="one cell a model: diffusion and nafnet at 256², batch 2")
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of the grid's models; remat and pipeline rows run only "
                         "for cells that are present (nafnet_s2d raises: not ported, on purpose)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--pad-tile", type=parse_tile, default=DEFAULT_PAD_TILE, metavar="SUB,LANE",
                    help="the padded figure's tile: M rounded to SUB, K and N to LANE (default 64,16: "
                         "Hopper's wgmma M and bf16 K step)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the device's peak bf16 TFLOP/s (default: device_peak_tflops, which knows "
                         "the card of record only and raises for any other device)")
    ap.add_argument("--json-out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available; pass --device cpu")
    grid = dict(QUICK if args.quick else GRID)
    if args.models:
        keep = [m.strip() for m in args.models.split(",") if m.strip()]
        if "nafnet_s2d" in keep:
            raise NotImplementedError(S2D_MESSAGE)
        unknown = [m for m in keep if m not in GRID]
        if unknown:
            raise ValueError(f"unknown models {unknown}; one of {MODELS}")
        grid = {k: v for k, v in grid.items() if k in keep}
    peak = args.peak_tflops if args.peak_tflops is not None else device_peak_tflops(device)
    smi = card() if device.type == "cuda" else None
    log(f"device: {device} ({smi}), peak {peak} TFLOP/s bf16, pad tile {args.pad_tile}")

    rows = []
    for model_kind, cells in grid.items():
        for img, b in cells:
            log(f"[{model_kind} {img}² b{b}]")
            dt = time_step(model_kind, img, b, device, inner=args.inner, reps=args.reps)
            model_f, padded_f = step_flops(model_kind, img, b, device, args.pad_tile)
            row = {
                "model": model_kind, "img": img, "batch": b,
                "ms_per_step": dt * 1e3,
                "imgs_per_s": b / dt,
                "model_tflop_per_step": model_f / 1e12,
                "mfu": mfu(model_f, dt, peak),
                "padded_tflop_per_step": padded_f / 1e12,
                "mfu_padded": mfu(padded_f, dt, peak),
            }
            rows.append(row)
            log(f"  {row['ms_per_step']:.2f} ms/step, {row['imgs_per_s']:.2f} img/s, "
                f"MFU {row['mfu'] * 100:.2f}% model / {row['mfu_padded'] * 100:.2f}% padded")

    def base_row(model_kind, img, b):
        return next((r for r in rows if (r["model"], r["img"], r["batch"]) == (model_kind, img, b)), None)

    remat = {}
    if not args.quick:
        for model_kind in grid:
            base = base_row(model_kind, 512, 2)
            if base is None:
                continue
            log(f"[{model_kind} 512² b2 remat]")
            dt_r = time_step(model_kind, 512, 2, device, remat=True, inner=args.inner, reps=args.reps)
            remat[model_kind] = {"ms_per_step": dt_r * 1e3, "vs_base": dt_r * 1e3 / base["ms_per_step"]}
            log(f"  remat {remat[model_kind]['ms_per_step']:.2f} ms/step ({remat[model_kind]['vs_base']:.3f}x)")

    pipeline = {}
    img, b = PIPELINE_CELL
    for model_kind in grid:
        base = base_row(model_kind, img, b)
        if base is None:
            continue
        log(f"[{model_kind} {img}² b{b} pipeline]")
        occ, wall_ms = pipeline_occupancy(model_kind, img, b, base["ms_per_step"], device)
        pipeline[model_kind] = {"wall_ms_per_step": wall_ms, "occupancy": occ}
        log(f"  wall {wall_ms:.2f} ms/step, occupancy {occ:.3f}")

    result = {
        "metric": "train ms/step + MFU (diffusion & nafnet recipes, bf16 compute, fp32 AdamW)",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "nvidia_smi": smi,
        "peak_tflops_assumed": peak,
        "pad_tile": list(args.pad_tile),
        "flops_layout": "plain (fuse_updown=False, use_flash=False)",
        "rows": rows,
        "remat_512_b2": remat,
        "pipeline": pipeline,
    }
    line = json.dumps(result)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
