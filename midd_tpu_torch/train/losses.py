"""The losses of the ported trainers (counterpart of the parts of
``midd_tpu/train/losses.py`` that the diffusion, NAFNet, expert and hybrid
trainers call):

- the diffusion loss, MSE on the clamped eps prediction plus 0.2 x the
  Sobel-edge L1 on the clamped x0 reconstruction (DDIM/DDIMModel.py:356-375);
- the NAFNet CombinedLoss, 1 mse + 0.5 l1 + 0.3 frequency + 0.2 edge
  (NafNet/NafnetModel.py:349-386);
- the expert HybridLoss, L1 + 0.4 (1 - SSIM) + 0.3 x a random-feature
  perceptual distance (DirectUNet/DirectUNetModel.py:257-268);
- the hybrid PerceptualLoss, mse + 0.5 l1 + 0.3 multi-scale L1
  (hybrid3diffusionspeed.py:421-445);
- the TinyUNet loss against the noise, 0.5 mse + 0.3 l1 + 0.2 per-direction
  Sobel L1 (newfastmodel/modelfunctions.py:176-191).

Single-channel NCHW tensors. The cddpm trainer's loss is plain ``mse``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from midd_tpu_torch.train.metrics import ssim

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


def edge_loss_xy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The TinyUNet's edge loss: the L1 of each Sobel direction, without the
    magnitude (newfastmodel/modelfunctions.py:176-181)."""
    return (l1(_conv3x3(pred, SOBEL_X), _conv3x3(target, SOBEL_X))
            + l1(_conv3x3(pred, SOBEL_Y), _conv3x3(target, SOBEL_Y)))


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


def frequency_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 of the rfft2 amplitudes over the spatial axes, norm "ortho"
    (NafNet:312-322), in fp32."""
    pf = torch.fft.rfft2(pred.float(), norm="ortho")
    tf = torch.fft.rfft2(target.float(), norm="ortho")
    return torch.mean(torch.abs(torch.abs(pf) - torch.abs(tf)))


def combined_loss_nafnet(pred: torch.Tensor, target: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The NAFNet CombinedLoss: 1 mse + 0.5 l1 + 0.3 freq + 0.2 edge (eps 1e-6)."""
    parts = {
        "mse": mse(pred, target),
        "l1": l1(pred, target),
        "freq": frequency_loss(pred, target),
        "edge": edge_loss(pred, target, eps=1e-6),
    }
    total = 1.0 * parts["mse"] + 0.5 * parts["l1"] + 0.3 * parts["freq"] + 0.2 * parts["edge"]
    return total, parts


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k mean over non-overlapping windows; a ragged edge is dropped
    (VALID), as in the JAX package."""
    return F.avg_pool2d(x, k)


def perceptual_loss_hybrid(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The hybrid trainer's loss: mse + 0.5 l1 + 0.3 x the mean L1 at scales
    1, 2 and 4."""
    loss_ms = 0.0
    for scale in (1, 2, 4):
        p = pred if scale == 1 else _avg_pool(pred, scale)
        t = target if scale == 1 else _avg_pool(target, scale)
        loss_ms = loss_ms + l1(p, t)
    return mse(pred, target) + 0.5 * l1(pred, target) + 0.3 * (loss_ms / 3.0)


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, dead_grad: bool = False) -> torch.Tensor:
    """1 - mean SSIM (the skimage-exact metric, differentiable).
    ``dead_grad=True`` detaches it, as the reference's numpy SSIM term
    carries no gradient (DirectUNet:17-23,266)."""
    loss = 1.0 - ssim(pred, target).mean()
    return loss.detach() if dead_grad else loss


def _feature_params(seed: int = 1234, in_ch: int = 1, widths=(16, 32, 64)) -> List[np.ndarray]:
    """The fixed random 3x3 conv stack that stands in for VGG19
    features[:16] (no pretrained weights offline), drawn as the JAX package
    draws it: He-normal HWIO kernels from ``numpy.random.default_rng(seed)``,
    here transposed to OIHW."""
    rng = np.random.default_rng(seed)
    params, c = [], in_ch
    for w in widths:
        k = rng.standard_normal((3, 3, c, w)).astype(np.float32) * (2.0 / (9 * c)) ** 0.5
        params.append(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        c = w
    return params


@functools.lru_cache(maxsize=None)
def _feature_weights(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The feature stack as fp32 constants on ``device``, built once per device."""
    return tuple(torch.from_numpy(k).to(device) for k in _feature_params())


def feature_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between the random-feature maps of pred and target: conv + ReLU,
    with a 2x average pool between layers, in fp32."""
    weights = _feature_weights(pred.device)

    def feats(x):
        h = x.float()
        for i, w in enumerate(weights):
            h = F.relu(F.conv2d(h, w, padding=1))
            if i < len(weights) - 1:
                h = _avg_pool(h, 2)
        return h

    return l1(feats(pred), feats(target))


def hybrid_loss_expert(pred: torch.Tensor, target: torch.Tensor, dead_grad_ssim: bool = False,
                       perceptual_weight: float = 0.3) -> torch.Tensor:
    """The expert trainer's loss: L1 + 0.4 (1 - SSIM) + perceptual_weight x
    the feature distance (dropped at weight 0)."""
    out = l1(pred, target) + 0.4 * ssim_loss(pred, target, dead_grad=dead_grad_ssim)
    if perceptual_weight:
        out = out + perceptual_weight * feature_loss(pred, target)
    return out


def combined_loss_tiny(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The TinyUNet loss against the noise target (modelfunctions.py:184-191)."""
    return 0.5 * mse(pred, target) + 0.3 * l1(pred, target) + 0.2 * edge_loss_xy(pred, target)
