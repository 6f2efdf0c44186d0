"""What ``POST /denoise`` answers, worked out in plain fp32 PyTorch and PIL:
the codec (reference service run.py:143-149, 193-203), the strided
deterministic reverse rollout with its eps refresh schedule
(DDIM/DDIMModel.py:251-289), the hybrid composition
(hybrid3diffusionspeed.py:560-628) and the four paths' clamps.

``answer`` takes the uploaded PNG bytes and returns the four answers as
uint8 arrays at the upload's size, as a client decodes the served PNGs.
The reference imports nothing of the port; it runs with TF32 off.
"""

from __future__ import annotations

import io
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

PATHS = ("diffusion", "nafnet", "expert", "hybrid")


def decode(data: bytes, size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Upload -> (S, S) fp32 in [0, 1] after a bicubic resize, and the (W, H) it had."""
    img = Image.open(io.BytesIO(data)).convert("L")
    return np.asarray(img.resize((size, size), Image.BICUBIC), np.float32) / 255.0, img.size


def encode(a: np.ndarray, original: Tuple[int, int]) -> np.ndarray:
    """(S, S) fp32 answer -> the uint8 image a client gets: clip, x255 and
    truncate, bicubic resize back to the upload's size."""
    img = Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8), mode="L")
    return np.asarray(img.resize(original, Image.BICUBIC))


def timesteps(noise_steps: int, steps: int) -> list:
    """reversed(range(0, T, T // steps)): "8 steps" over 50 run as 9."""
    return list(reversed(range(0, noise_steps, max(1, noise_steps // steps))))


def rollout(unet, noisy: torch.Tensor, schedule: Dict, steps: int, refresh: Sequence[int]) -> torch.Tensor:
    """From the noisy image: eps (clamped to +-5) at the refresh indices and
    reused between them, the posterior mean, x clamped to [0, 1] each step."""
    beta = torch.linspace(schedule["beta_start"], schedule["beta_end"], schedule["noise_steps"],
                          dtype=torch.float32, device=noisy.device)
    alpha = 1.0 - beta
    alpha_hat = torch.cumprod(alpha, 0)
    x, eps = noisy, None
    for i, t in enumerate(timesteps(schedule["noise_steps"], steps)):
        if i in refresh:
            eps = unet(x, noisy, torch.full((noisy.shape[0],), t, dtype=torch.int64,
                                            device=noisy.device)).clamp(-5.0, 5.0)
        x = ((x - (1 - alpha[t]) / torch.sqrt(1 - alpha_hat[t]) * eps) / torch.sqrt(alpha[t])).clamp(0, 1)
    return x


def sanitize(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0).clamp(0, 1)


@torch.no_grad()
def paths(models: Dict, cfg: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The four paths on a (B, 1, S, S) batch, and the hybrid's fusion
    inputs other than its rollout (``fast``, ``mask``). The hybrid's
    backends are the standalone checkpoints (its own holds router and
    fusion only) and its rollout has the standalone's steps and schedule, so
    it is the same rollout, computed once."""
    diff = rollout(models["diffusion"], x, cfg["schedule"], cfg["diffusion_steps"], cfg["refresh"])
    naf = models["nafnet"](x)
    mask = sanitize(models["hybrid"].router(x))
    hybrid = fuse(models, sanitize(naf), diff, mask)
    return {"diffusion": diff.clamp(0, 1), "nafnet": naf.clamp(0, 1),
            "expert": models["expert"](x).clamp(0, 1), "hybrid": hybrid,
            "fast": sanitize(naf), "mask": mask}


@torch.no_grad()
def fuse(models: Dict, fast: torch.Tensor, hq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The hybrid's answer from its three inputs, ``hq`` its rollout's raw
    output."""
    return models["hybrid"].fusion(fast, sanitize(hq), mask).clamp(0, 1)


def answer(models: Dict, cfg: Dict, uploads: Sequence[bytes], device, rows: int = 4, stages: bool = False) -> list:
    """The four uint8 answers of each upload, ``rows`` uploads a batch; with
    ``stages``, each answer also holds its decoded input ``x``, its size
    ``original``, and the hybrid's ``fast`` and ``mask`` (1, 1, S, S), on
    ``device``."""
    size = cfg["img_size"]
    out = []
    for lo in range(0, len(uploads), rows):
        decoded = [decode(u, size) for u in uploads[lo:lo + rows]]
        x = torch.from_numpy(np.stack([a for a, _ in decoded]))[:, None].to(device)
        ys = paths(models, cfg, x)
        host = {k: ys[k][:, 0].cpu().numpy() for k in PATHS}
        for i, (_, orig) in enumerate(decoded):
            a = {k: encode(host[k][i], orig) for k in PATHS}
            if stages:
                a.update(x=x[i:i + 1], original=orig, fast=ys["fast"][i:i + 1], mask=ys["mask"][i:i + 1])
            out.append(a)
    return out
