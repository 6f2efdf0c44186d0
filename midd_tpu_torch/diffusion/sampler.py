"""Deterministic reverse rollout and the training-time noising helpers
(counterpart of ``midd_tpu/diffusion/sampler.py``: ``denoise`` with
``stochastic=False``, ``noise_images`` and ``sample_timesteps``).

Semantics of the reference restorer (DDIM/DDIMModel.py:268-289): the loop
starts from the noisy image, eps is clamped to [-5, 5], the posterior-mean
update runs in fp32 and x is clamped to [0, 1] after each step. It is a
Python loop: a step that reuses eps does not evaluate the UNet at all.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from midd_tpu_torch.diffusion.schedule import Schedule, timestep_sequence

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def refresh_steps(n_steps: int, eps_reuse: int = 1,
                  eps_refresh_idx: Optional[Sequence[int]] = None) -> set:
    """The scan indices that compute fresh eps: every ``eps_reuse``-th step,
    or the explicit ``eps_refresh_idx`` set, which must hold step 0."""
    if eps_refresh_idx is not None:
        idx = {int(i) for i in eps_refresh_idx}
        if 0 not in idx:
            raise ValueError("eps_refresh_idx must contain step 0")
        return {i for i in idx if i < n_steps}
    return {i for i in range(n_steps) if i % eps_reuse == 0}


def denoise(
    eps_fn: EpsFn,
    noisy: torch.Tensor,
    schedule: Schedule,
    inference_steps: int,
    *,
    clamp_eps: bool = True,
    eps_reuse: int = 1,
    eps_refresh_idx: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Run the rollout; ``eps_fn(x, condition, t)`` is the UNet (t: (B,)
    int64). Returns the denoised image, same shape and dtype as ``noisy``."""
    ts = timestep_sequence(schedule.noise_steps, inference_steps)
    fresh = refresh_steps(len(ts), eps_reuse, eps_refresh_idx)
    sched = schedule.to(noisy.device)
    x = noisy
    eps = None
    for i, t in enumerate(ts):
        if i in fresh:
            t_b = torch.full((noisy.shape[0],), t, dtype=torch.int64, device=noisy.device)
            e = eps_fn(x, noisy, t_b)
            if clamp_eps:
                e = e.clamp(-5.0, 5.0)
            eps = e.float()
        a = sched.alpha[t]
        ah = sched.alpha_hat[t]
        mean = (x.float() - ((1.0 - a) / torch.sqrt(1.0 - ah)) * eps) / torch.sqrt(a)
        x = mean.clamp(0.0, 1.0).to(noisy.dtype)
    return x


def noise_images(x: torch.Tensor, t: torch.Tensor, schedule: Schedule,
                 generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward noising q(x_t | x_0) for training (DDIM/DDIMModel.py:259-263):
    eps ~ N(0, I) drawn from ``generator`` (on ``x``'s device), returns
    (sqrt(ah) x + sqrt(1 - ah) eps, eps)."""
    ah = schedule.to(x.device).alpha_hat[t][:, None, None, None]
    eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return torch.sqrt(ah) * x + torch.sqrt(1.0 - ah) * eps, eps


def sample_timesteps(generator: torch.Generator, n: int, noise_steps: int) -> torch.Tensor:
    """Uniform t in [1, noise_steps) (DDIM/DDIMModel.py:265-266), (n,) int64
    on the generator's device."""
    return torch.randint(1, noise_steps, (n,), generator=generator, device=generator.device)
