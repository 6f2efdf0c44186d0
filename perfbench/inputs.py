"""Seeded uploads: synthetic radiographs, the reference noise families and
their PNG bytes. Standard library and numpy only, so that the load
generator's process imports nothing else.

Every seed gets the same set of upload sizes and noise families, in its own
order, so that seeds change the pixels and the order and not the amount of
work: each side of the original is one of ``n`` evenly spaced sizes in
0.75-1.25x the served size, and the families take turns.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

FAMILIES = ("gaussian", "speckle", "poisson")
BOUNDARY = "perfbenchboundary"


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *keys])


def add_noise(img: np.ndarray, family: str, rng: np.random.Generator) -> np.ndarray:
    """The reference trainer's three corruptions (gaussian sigma 0.1,
    multiplicative speckle 0.2, Poisson counts at peak 30), clipped to [0, 1]."""
    if family == "gaussian":
        return np.clip(img + rng.normal(0.0, 0.1, img.shape).astype(np.float32), 0, 1)
    if family == "speckle":
        return np.clip(img * (1.0 + rng.normal(0.0, 0.2, img.shape).astype(np.float32)), 0, 1)
    if family == "poisson":
        return np.clip(rng.poisson(np.clip(img, 0, 1) * 30.0).astype(np.float32) / 30.0, 0, 1)
    raise ValueError(f"unknown noise family {family!r}")


def radiograph(rng: np.random.Generator, width: int, height: int) -> np.ndarray:
    """A smooth body (torso, two darker lung fields, a spine) with film grain,
    (height, width) float32 in [0, 1]."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy, xx = yy / height, xx / width
    cx, cy = rng.uniform(0.45, 0.55, 2)
    img = 0.15 + 0.45 * np.exp(-(((xx - cx) / rng.uniform(0.3, 0.4)) ** 2 + ((yy - cy) / rng.uniform(0.4, 0.5)) ** 2))
    for side in (-1.0, 1.0):
        lx, ly = cx + side * rng.uniform(0.13, 0.18), cy - rng.uniform(0.02, 0.08)
        img -= 0.15 * np.exp(-(((xx - lx) / 0.11) ** 2 + ((yy - ly) / 0.22) ** 2))
    img += 0.12 * np.exp(-(((xx - cx) / 0.03) ** 2))
    img += 0.03 * rng.standard_normal((height, width)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def noisy_image(rng: np.random.Generator, width: int, height: int, family: str) -> np.ndarray:
    return add_noise(radiograph(rng, width, height), family, rng)


def plan(seed: int, n: int, img_size: int) -> List[Tuple[int, int, str]]:
    """(width, height, noise family) of each of ``n`` uploads."""
    sides = [round(img_size * (0.75 + 0.5 * (k + 0.5) / n)) for k in range(n)]
    rng = _rng(seed, 0)
    widths, heights = rng.permutation(sides), rng.permutation(sides)
    families = rng.permutation([FAMILIES[k % 3] for k in range(n)])
    return [(int(w), int(h), str(f)) for w, h, f in zip(widths, heights, families)]


def png(img: np.ndarray) -> bytes:
    """8-bit grayscale PNG of a [0, 1] image (zlib level 6, as PIL writes)."""
    a = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    raw = np.concatenate([np.zeros((a.shape[0], 1), np.uint8), a], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", a.shape[1], a.shape[0], 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def upload(seed: int, index: int, img_size: int, n: int) -> bytes:
    """The PNG bytes of upload ``index`` of ``n``."""
    w, h, family = plan(seed, n, img_size)[index]
    return png(noisy_image(_rng(seed, 1, index), w, h, family))


def multipart(data: bytes) -> Tuple[bytes, str]:
    """(body, content type) of a form upload with one ``file`` field."""
    head = (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"xray.png\"\r\n"
            f"Content-Type: image/png\r\n\r\n").encode()
    return head + data + f"\r\n--{BOUNDARY}--\r\n".encode(), f"multipart/form-data; boundary={BOUNDARY}"


def gaps(seed: int, rate: float, seconds: float) -> List[float]:
    """Poisson inter-arrival gaps: round(rate * seconds) exponential
    quantiles at ``rate`` per second, scaled to end one mean gap before
    ``seconds``. Every seed gets the same set, in its own order, so every
    seed offers the same requests in the window."""
    n = max(1, round(rate * seconds))
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    q *= seconds * n / (n + 1) / q.sum()
    return [float(g) for g in _rng(seed, 2).permutation(q)]
