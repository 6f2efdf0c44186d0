"""PSNR / SSIM matching the skimage defaults (counterpart of
``midd_tpu/train/metrics.py``).

The reference calls ``skimage.metrics.peak_signal_noise_ratio`` and
``structural_similarity`` with ``data_range=1.0``. SSIM follows the skimage
defaults exactly: 7x7 uniform window (scipy ``uniform_filter`` with
``mode='reflect'``, which duplicates the edge sample), K1=0.01, K2=0.03,
unbiased covariance normalisation NP/(NP-1), and the edge-cropped mean.

Images are (B, H, W), (H, W) or single-channel NCHW (B, 1, H, W), the port's
layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _to_bhw(x: torch.Tensor) -> torch.Tensor:
    """Accept (B,1,H,W), (B,H,W) or (H,W) and return (B,H,W)."""
    if x.dim() == 2:
        return x[None]
    if x.dim() == 4:
        if x.shape[1] != 1:
            raise ValueError(f"expected single-channel NCHW images, got {tuple(x.shape)}")
        return x[:, 0]
    if x.dim() == 3:
        return x
    raise ValueError(f"unsupported image rank: {tuple(x.shape)}")


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR. Returns shape (B,)."""
    p, t = _to_bhw(pred), _to_bhw(target)
    err = torch.mean(torch.square(p - t), dim=(-2, -1))
    return 10.0 * torch.log10((data_range * data_range) / err)


def _uniform_filter(img: torch.Tensor, size: int = 7) -> torch.Tensor:
    """scipy.ndimage.uniform_filter(img, size, mode='reflect') over the last
    two axes of (B, H, W): symmetric padding (the edge sample repeated), then
    a separable box mean."""
    pad = size // 2

    def sym(x, dim):
        n = x.shape[dim]
        return torch.cat([x.narrow(dim, 0, pad).flip(dim), x,
                          x.narrow(dim, n - pad, pad).flip(dim)], dim=dim)

    xp = sym(sym(img, -2), -1)[:, None]
    xp = F.avg_pool2d(xp, (size, 1), stride=1)
    return F.avg_pool2d(xp, (1, size), stride=1)[:, 0]


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM matching the skimage defaults. Returns shape (B,)."""
    x, y = _to_bhw(pred), _to_bhw(target)
    filt = lambda im: _uniform_filter(im, win_size)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)  # skimage use_sample_covariance=True

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[:, pad:-pad, pad:-pad].mean(dim=(-2, -1))


def compute_metrics(pred: torch.Tensor, target: torch.Tensor,
                    flat_psnr_fallback: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-mean (PSNR, SSIM) with [0,1] clipping, in fp32 whatever the
    input dtype. ``flat_psnr_fallback=True`` reports 40 dB where the target
    image is constant (hybrid3diffusionspeed.py:461-464)."""
    p = _to_bhw(pred).float().clamp(0.0, 1.0)
    t = _to_bhw(target).float().clamp(0.0, 1.0)
    psnr_vals = psnr(p, t)
    if flat_psnr_fallback:
        flat = (t.amax(dim=(-2, -1)) - t.amin(dim=(-2, -1))) == 0
        psnr_vals = torch.where(flat, torch.full_like(psnr_vals, 40.0), psnr_vals)
    return psnr_vals.mean(), ssim(p, t).mean()
