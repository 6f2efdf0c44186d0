"""Single-image inference CLI and test-time augmentation (counterpart of
``midd_tpu/inference.py``): one model path of the serving engine on one
image, optionally averaged over the 4-flip TTA of the reference's NAFNet
inference (NafNet/NafnetModel.py:670-692).

    python -m midd_tpu_torch.inference --model nafnet --image x.png --out out.png \
        [--ckpt-dir checkpoints] [--tta] [--steps 8] [--img-size 512] [--device cuda]

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from PIL import Image

from midd_tpu_torch.serve.codec import decode_to_tensor
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine

# the gated non-exact serving defaults, pinned off for a reference comparison
REFERENCE_EXACT = dict(turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1,
                       diffusion_eval_bf16=False, hybrid_rollout_bf16=False)


def tta_4flip(fn: Callable[[np.ndarray], np.ndarray]) -> Callable[[np.ndarray], np.ndarray]:
    """Average ``fn`` over the identity, horizontal, vertical and both flips
    of an NHWC batch, un-flipping each prediction: four calls of ``fn``."""

    def wrapped(x: np.ndarray) -> np.ndarray:
        preds = [
            fn(x),
            np.flip(fn(np.flip(x, axis=2)), axis=2),
            np.flip(fn(np.flip(x, axis=1)), axis=1),
            np.flip(fn(np.flip(x, axis=(1, 2))), axis=(1, 2)),
        ]
        return np.mean(np.stack(preds), axis=0)

    return wrapped


def denoise_image(
    model: str,
    image_path: str,
    ckpt_dir: str = "checkpoints",
    img_size: int = 512,
    steps: int = 8,
    tta: bool = False,
    bf16: bool = False,
    serving_defaults: bool = False,
    device: str = "cuda",
):
    """Returns (PIL.Image at the original size, seconds of the one call,
    cuDNN's first-call set-up included). Reference-exact numerics unless
    ``serving_defaults``: the turbo refresh schedule and bf16 UNet evals
    are pinned off."""
    cfg = EngineConfig(
        img_size=img_size,
        diffusion_steps=steps,
        hybrid_diffusion_steps=steps,
        ckpt_dir=ckpt_dir,
        compute_dtype=torch.bfloat16 if bf16 else None,
        warmup=False,
        device=device,
        **({} if serving_defaults else REFERENCE_EXACT),
    )
    engine = InferenceEngine(cfg)
    try:
        fn = engine.fns[model]
        if tta:
            fn = tta_4flip(fn)
        with open(image_path, "rb") as f:
            x, original_size = decode_to_tensor(f.read(), img_size)
        t0 = time.time()
        out = fn(x)
        dt = time.time() - t0
    finally:
        engine.close()
    arr = (np.clip(out[0, :, :, 0], 0, 1) * 255).astype(np.uint8)
    img = Image.fromarray(arr, mode="L").resize(original_size, Image.BICUBIC)
    return img, dt


def save_comparison(noisy_path: str, denoised_img, out_path: str) -> bool:
    """Noisy / denoised / difference side by side (the reference's
    visualize_results, NafNet/NafnetModel.py:713-736). Without matplotlib
    it says so and returns False; it never raises for that."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: comparison {out_path} not written")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    original = Image.open(noisy_path).convert("L")
    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    axes[0].imshow(original, cmap="gray")
    axes[0].set_title("Noisy Input")
    axes[1].imshow(denoised_img, cmap="gray")
    axes[1].set_title("Denoised")
    diff = np.abs(
        np.asarray(original.resize(denoised_img.size), np.float32)
        - np.asarray(denoised_img, np.float32)
    )
    axes[2].imshow(diff, cmap="hot")
    axes[2].set_title("Noise Removed (difference)")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return True


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=MODEL_NAMES, required=True)
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="denoised.png")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--serving-defaults", action="store_true",
                    help="the serving stack's turbo refresh schedule and bf16 UNet evals "
                         "in place of the default reference-exact numerics")
    ap.add_argument("--compare", default=None,
                    help="also save a noisy/denoised/difference comparison figure")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    img, dt = denoise_image(
        args.model, args.image, ckpt_dir=args.ckpt_dir, img_size=args.img_size,
        steps=args.steps, tta=args.tta, bf16=args.bf16,
        serving_defaults=args.serving_defaults, device=args.device,
    )
    img.save(args.out)
    print(f"{args.model}: {dt:.3f}s -> {args.out}")
    if args.compare and save_comparison(args.image, img, args.compare):
        print(f"comparison -> {args.compare}")


if __name__ == "__main__":
    main()
