"""The procedural X-ray phantoms of the JAX package's benchmark (a copy of
``make_phantoms`` from ``midd_tpu/benchmarks/xray_bench.py``; the port
imports nothing of ``midd_tpu``). numpy-seeded, so both packages make the
identical images. The engine's static-int8 calibration runs on them; the
rest of that benchmark is not ported yet.
"""

from __future__ import annotations

import numpy as np


def make_phantoms(n: int, size: int, seed: int) -> np.ndarray:
    """Structured synthetic radiographs: torso with soft-tissue gradient,
    darker lung fields, spine column, periodic ribs, and bright nodules —
    enough anatomical structure that edge/SSIM terms and the denoisers'
    frequency behavior are exercised like on real X-rays. Deterministic in
    (n, size, seed). Returns (N, H, W, 1) float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = []
    for _ in range(n):
        # background illumination + soft tissue
        img = 0.18 + 0.22 * (
            xx * rng.uniform(0.4, 1.4) + yy * rng.uniform(0.3, 1.1)
        ) / 2.0
        # torso: bright wide ellipse
        cx, cy = rng.uniform(0.45, 0.55), rng.uniform(0.45, 0.55)
        d = ((xx - cx) / rng.uniform(0.32, 0.42)) ** 2 + (
            (yy - cy) / rng.uniform(0.42, 0.5)
        ) ** 2
        img = img + 0.35 * np.exp(-d * 1.6)
        # lung fields: two darker ellipses inside the torso
        for sx in (-1.0, 1.0):
            lx = cx + sx * rng.uniform(0.13, 0.19)
            ly = cy - rng.uniform(0.02, 0.08)
            dl = ((xx - lx) / rng.uniform(0.1, 0.14)) ** 2 + (
                (yy - ly) / rng.uniform(0.18, 0.26)
            ) ** 2
            img = img - rng.uniform(0.12, 0.2) * np.exp(-dl * 2.2)
        # spine: bright vertical column
        img = img + rng.uniform(0.08, 0.14) * np.exp(
            -(((xx - cx) / rng.uniform(0.025, 0.04)) ** 2)
        )
        # ribs: periodic bands inside the torso envelope
        freq = rng.uniform(7, 13)
        phase = rng.uniform(0, np.pi)
        img = img + 0.05 * np.maximum(
            0, np.sin(yy * np.pi * freq + phase)
        ) * np.exp(-d * 1.6)
        # nodules / calcifications: small bright blobs
        for _ in range(rng.integers(1, 4)):
            bx, by = rng.uniform(0.25, 0.75, 2)
            br = rng.uniform(0.01, 0.04)
            db = ((xx - bx) ** 2 + (yy - by) ** 2) / br**2
            img = img + rng.uniform(0.1, 0.25) * np.exp(-db)
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs)[..., None].astype(np.float32)
