"""The diffusion trainer's loss (counterpart of the part of
``midd_tpu/train/losses.py`` that ``train_diffusion`` calls): MSE on the
clamped eps prediction plus 0.2 x the Sobel-edge L1 on the clamped x0
reconstruction (DDIM/DDIMModel.py:356-375). Single-channel NCHW tensors.

The NAFNet, expert, hybrid and tiny loss suites are ROADMAP.md queue 1
item 11.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def _conv3x3(x: torch.Tensor, taps) -> torch.Tensor:
    """3x3 zero-padded correlation of a single-channel NCHW batch, fp32."""
    k = torch.tensor(taps, dtype=torch.float32, device=x.device)[None, None]
    return F.conv2d(x.float(), k, padding=1)


def sobel_magnitude(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    gx = _conv3x3(x, SOBEL_X)
    gy = _conv3x3(x, SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy + eps)


def edge_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return l1(sobel_magnitude(pred, eps), sobel_magnitude(target, eps))


def diffusion_loss(
    eps_pred: torch.Tensor,
    eps_true: torch.Tensor,
    x_t: torch.Tensor,
    clean: torch.Tensor,
    alpha_hat_t: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """eps clamped to [-5, 5], x0 reconstructed and clamped to [0, 1], then
    MSE(eps) + 0.2 * Sobel-edge L1 on the reconstruction (eps 1e-8)."""
    eps_pred = eps_pred.clamp(-5.0, 5.0)
    ah = alpha_hat_t[:, None, None, None]
    pred_clean = ((x_t - torch.sqrt(1.0 - ah) * eps_pred) / torch.sqrt(ah)).clamp(0.0, 1.0)
    parts = {
        "mse": mse(eps_pred, eps_true),
        "edge": edge_loss(pred_clean, clean, eps=1e-8),
    }
    return parts["mse"] + 0.2 * parts["edge"], parts
