"""Dataset evaluation (counterpart of ``midd_tpu/evaluate.py``): PSNR, SSIM
and median latency of one model path over a paired test set, as the
reference's headline numbers are measured.

    python -m midd_tpu_torch.evaluate --model hybrid --clear-dir data/clean \
        --noisy-dirs data/noisy --ckpt-dir checkpoints [--tta] [--device cuda]

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from midd_tpu_torch.inference import REFERENCE_EXACT, tta_4flip
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.train.metrics import compute_metrics


def evaluate(
    model: str,
    dataset,
    ckpt_dir: str = "checkpoints",
    img_size: int = 512,
    steps: int = 8,
    tta: bool = False,
    bf16: bool = False,
    engine_kwargs: Optional[dict] = None,
    engine: Optional[InferenceEngine] = None,
    serving_defaults: bool = False,
    device: str = "cuda",
) -> dict:
    """{"model", "n", "psnr", "ssim", "p50_latency_s"} over ``dataset``'s
    (clean, noisy) pairs. The latency leaves the first call out (cuDNN's
    set-up). Reference-exact numerics unless ``serving_defaults`` (the
    turbo refresh schedule and bf16 UNet evals pinned off), as a measurement
    compared with the reference must not silently include them. An
    ``engine`` given is used as it is, and left open."""
    own = engine is None
    if own:
        kw = dict(engine_kwargs or {})
        if not serving_defaults:
            for key, value in REFERENCE_EXACT.items():
                kw.setdefault(key, value)
        engine = InferenceEngine(EngineConfig(
            img_size=img_size,
            diffusion_steps=steps,
            hybrid_diffusion_steps=steps,
            ckpt_dir=ckpt_dir,
            compute_dtype=torch.bfloat16 if bf16 else None,
            warmup=False,
            device=device,
            **kw,
        ))
    fn = engine.fns[model]
    if tta:
        fn = tta_4flip(fn)

    psnrs, ssims, times = [], [], []
    try:
        for i in range(len(dataset)):
            clean, noisy = dataset[i]
            t0 = time.time()
            pred = fn(noisy[None])
            if i > 0:
                times.append(time.time() - t0)
            p, s = compute_metrics(torch.from_numpy(np.ascontiguousarray(pred[..., 0])),
                                   torch.from_numpy(np.ascontiguousarray(clean[None, ..., 0])))
            if np.isfinite(float(p)):
                psnrs.append(float(p))
                ssims.append(float(s))
    finally:
        if own:
            engine.close()

    return {
        "model": model,
        "n": len(psnrs),
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "p50_latency_s": float(np.median(times)) if times else float("nan"),
    }


def main(argv=None):
    import argparse

    from midd_tpu_torch.train.data import PairedXRayDataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=MODEL_NAMES)
    ap.add_argument("--clear-dir", required=True)
    ap.add_argument("--noisy-dirs", nargs="+", required=True)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--max-samples", type=int, default=500)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--serving-defaults", action="store_true",
                    help="measure the serving stack's turbo refresh schedule and bf16 UNet "
                         "evals in place of the default reference-exact numerics")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dataset = PairedXRayDataset(args.clear_dir, args.noisy_dirs, img_size=args.img_size,
                                max_samples=args.max_samples, is_train=False)
    result = evaluate(args.model, dataset, ckpt_dir=args.ckpt_dir, img_size=args.img_size,
                      steps=args.steps, tta=args.tta, bf16=args.bf16,
                      serving_defaults=args.serving_defaults, device=args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
