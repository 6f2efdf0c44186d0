"""DDPM scheduler of the TinyUNet pipeline (counterpart of
``midd_tpu/diffusion/ddpm_scheduler.py``), with the semantics of the
diffusers ``DDPMScheduler`` defaults that the reference trains against
(1000 timesteps, linear betas 1e-4..0.02, epsilon prediction,
newfastmodel/fastmodeltraining.py:27):

- ``add_noise``: sqrt(ac_t) x0 + sqrt(1 - ac_t) eps;
- leading timestep spacing: t_i = (T // steps) * i, descending;
- ``step``: the epsilon-parameterised posterior with x0 clipped to [-1, 1]
  and the fixed-small variance (clamped at 1e-20), noise added for t > 0;
- ``sample``: the rollout from the conditioning image itself, in [-1, 1]
  (Backend/denoiser.py:35-47), a Python loop over the timesteps.

Noise comes from an explicit ``torch.Generator`` (one standard normal of the
sample's shape per step, t = 0 included, as the JAX package draws one per
key) or from a given ``noise_seq``.
"""

from __future__ import annotations

import io
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch

from midd_tpu_torch import config
from midd_tpu_torch.models.tiny_unet import TinyUNet


class DDPMScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 0.02, clip_sample: bool = True):
        self.num_train_timesteps = num_train_timesteps
        self.betas = torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
        self.alphas = 1.0 - self.betas
        self.alphas_cumprod = torch.cumprod(self.alphas, dim=0)
        self.clip_sample = clip_sample

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        ac = self.alphas_cumprod.to(x0.device)[t][:, None, None, None]
        return torch.sqrt(ac) * x0 + torch.sqrt(1.0 - ac) * noise

    def timesteps(self, steps: int) -> List[int]:
        ratio = self.num_train_timesteps // steps
        return [ratio * i for i in reversed(range(steps))]

    def step(self, eps: torch.Tensor, t: int, sample: torch.Tensor, steps: int,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse step from ``sample`` at timestep ``t``; ``noise`` (a
        standard normal of the sample's shape) is added, scaled by the
        posterior's standard deviation, where t > 0."""
        t = int(t)
        prev_t = t - self.num_train_timesteps // steps
        ac = self.alphas_cumprod.to(sample.device)
        a_t = ac[t]
        a_prev = ac[prev_t] if prev_t >= 0 else torch.ones((), device=sample.device)
        beta_t = 1.0 - a_t / a_prev
        alpha_t = a_t / a_prev

        x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        coef_x0 = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)
        mean = coef_x0 * x0 + coef_xt * sample
        if noise is not None and t > 0:
            var = ((1.0 - a_prev) / (1.0 - a_t) * beta_t).clamp_min(1e-20)
            mean = mean + torch.sqrt(var) * noise
        return mean

    def sample(self, eps_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
               cond: torch.Tensor, steps: int = 12, generator: Optional[torch.Generator] = None,
               noise_seq: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rollout from ``cond`` itself; ``eps_fn(latents, t_batch,
        cond)``. Deterministic (the posterior mean) unless ``generator`` (on
        ``cond``'s device) or ``noise_seq``, shaped (steps, *cond.shape),
        gives the noise."""
        if noise_seq is not None:
            noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32, device=cond.device)
            if tuple(noise_seq.shape) != (steps, *cond.shape):
                raise ValueError(f"noise_seq shape {tuple(noise_seq.shape)} != {(steps, *cond.shape)}")
        latents = cond
        for i, t in enumerate(self.timesteps(steps)):
            t_b = torch.full((cond.shape[0],), t, dtype=torch.int64, device=cond.device)
            eps = eps_fn(latents, t_b, cond)
            if noise_seq is not None:
                noise = noise_seq[i]
            elif generator is not None:
                noise = torch.randn(cond.shape, generator=generator, device=cond.device,
                                    dtype=torch.float32)
            else:
                noise = None
            latents = self.step(eps, t, latents, steps, noise)
        return latents


class TinyUNetDenoiser:
    """The reference's legacy ``XRayDenoiser`` (Backend/denoiser.py:9-53),
    working: 256x256, the [-1, 1] domain, a 12-step DDPM rollout. ``params``
    is a TinyUNet ``state_dict``; it runs on the card unless ``device`` says
    "cpu"."""

    def __init__(self, params: Mapping[str, torch.Tensor], model: Optional[TinyUNet] = None,
                 img_size: int = 256, steps: int = 12, device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TinyUNetDenoiser device is cuda but no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        self.model = model or TinyUNet(config.TINY_UNET)
        self.model.load_state_dict(params, strict=True)
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self.img_size = img_size
        self.steps = steps
        self.scheduler = DDPMScheduler()

    @torch.no_grad()
    def denoise(self, image_bytes: bytes, generator: Optional[torch.Generator] = None):
        """PNG (or any PIL-readable) bytes in, a grayscale PIL image of
        ``img_size`` out; the noise comes from ``generator`` (default: one
        seeded 0 on the device, as the JAX package's PRNGKey(0))."""
        from PIL import Image

        img = Image.open(io.BytesIO(image_bytes)).convert("L")
        resized = img.resize((self.img_size, self.img_size), Image.BICUBIC)
        x = torch.from_numpy(np.asarray(resized, np.float32) / 255.0)[None, None].to(self.device)
        x = x * 2.0 - 1.0  # Normalize([0.5], [0.5])
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = self.scheduler.sample(self.model, x, steps=self.steps, generator=generator)
        arr = np.clip((out[0, 0].cpu().numpy() + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
        return Image.fromarray(arr, mode="L")
