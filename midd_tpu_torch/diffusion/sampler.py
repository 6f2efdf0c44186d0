"""Reverse rollout and the training-time noising helpers (counterpart of
``midd_tpu/diffusion/sampler.py``: ``denoise``, ``refresh_schedule``,
``noise_images`` and ``sample_timesteps``).

Semantics of the reference restorers: the loop starts from the noisy image
and applies the posterior-mean update in fp32, clamping x to [0, 1] after
each step.

- deterministic (DDIM/DDIMModel.py:268-289): eps clamped to [-5, 5];
- ancestral (the cddpm variant, cddpm/cddpmModels.py:290-303): no eps
  clamp, and the posterior noise sqrt(beta_t) * (0.5 * N(0, I)) added for
  t > 0.

It is a Python loop: a step that reuses eps does not evaluate the UNet at
all. The ancestral noise comes from an explicit ``torch.Generator`` (one
standard normal of x's shape per step, t = 0 included, as the JAX package
draws one per key) or from a given ``noise_seq``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from midd_tpu_torch.diffusion.schedule import Schedule, timestep_sequence

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _is_mask(idx) -> bool:
    dtype = getattr(idx, "dtype", None)
    if dtype is not None:
        return dtype in (torch.bool, np.bool_)
    return len(idx) > 0 and all(isinstance(i, (bool, np.bool_)) for i in idx)


def refresh_steps(n_steps: int, eps_reuse: int = 1, eps_refresh_idx=None) -> set:
    """The scan indices that compute fresh eps: every ``eps_reuse``-th step,
    or ``eps_refresh_idx``: an index set, which must hold step 0, or a bool
    mask (a sequence, array or tensor) of length ``n_steps``, which need not
    (a step that reuses eps before any was computed reuses zeros, as in the
    JAX package)."""
    if eps_refresh_idx is None:
        return {i for i in range(n_steps) if i % eps_reuse == 0}
    if _is_mask(eps_refresh_idx):
        mask = [bool(b) for b in (eps_refresh_idx.tolist() if hasattr(eps_refresh_idx, "tolist")
                                  else eps_refresh_idx)]
        if len(mask) != n_steps:
            raise ValueError(
                f"refresh mask shape ({len(mask)},) != ({n_steps},) "
                f"(the ACTUAL rollout length from timestep_sequence, "
                f"not the requested inference_steps)"
            )
        return {i for i, fresh in enumerate(mask) if fresh}
    idx = {int(i) for i in eps_refresh_idx}
    if 0 not in idx:
        raise ValueError("eps_refresh_idx must contain step 0")
    return {i for i in idx if i < n_steps}


def denoise(
    eps_fn: EpsFn,
    noisy: torch.Tensor,
    schedule: Schedule,
    inference_steps: int,
    *,
    stochastic: bool = False,
    clamp_eps: bool = True,
    query_noise_scale: float = 0.5,
    generator: Optional[torch.Generator] = None,
    eps_reuse: int = 1,
    eps_refresh_idx=None,
    noise_seq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the rollout; ``eps_fn(x, condition, t)`` is the UNet (t: (B,)
    int64). Returns the denoised image, same shape and dtype as ``noisy``.

    ``stochastic``: the ancestral update, its standard normals drawn from
    ``generator`` (on ``noisy``'s device) or taken from ``noise_seq``, shaped
    (n_steps, *noisy.shape) with n_steps the length of the rollout
    (``timestep_sequence``), as given."""
    ts = timestep_sequence(schedule.noise_steps, inference_steps)
    if stochastic and generator is None and noise_seq is None:
        raise ValueError("stochastic sampling requires a generator or noise_seq")
    if noise_seq is not None:
        if not stochastic:
            # the injected noise is only consumed by the ancestral update
            raise ValueError("noise_seq requires stochastic=True")
        noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32, device=noisy.device)
        if tuple(noise_seq.shape) != (len(ts), *noisy.shape):
            raise ValueError(f"noise_seq shape {tuple(noise_seq.shape)} != "
                             f"{(len(ts), *noisy.shape)}")
    fresh = refresh_steps(len(ts), eps_reuse, eps_refresh_idx)
    sched = schedule.to(noisy.device)
    x = noisy
    eps = torch.zeros(noisy.shape, dtype=torch.float32, device=noisy.device) if 0 not in fresh else None
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
        if stochastic:
            z = noise_seq[i] if noise_seq is not None else torch.randn(
                noisy.shape, generator=generator, device=noisy.device, dtype=torch.float32)
            if t > 0:
                mean = mean + torch.sqrt(sched.beta[t]) * (z * query_noise_scale)
        x = mean.clamp(0.0, 1.0).to(noisy.dtype)
    return x


def refresh_schedule(n_steps: int, n_evals: int, mode: str = "uniform") -> tuple:
    """Which scan indices compute fresh eps, for a budget of ``n_evals`` UNet
    evaluations over ``n_steps`` rollout steps (index 0 always included):

    - "uniform": evenly spaced, by rounding;
    - "last": evenly spaced over the first steps, the final step always fresh;
    - "front": all evals at the start;
    - "tail": index 0 plus the last n_evals - 1 steps.

    Python's ``round`` (half to even), as in the JAX package."""
    if n_evals >= n_steps:
        return tuple(range(n_steps))
    if n_evals < 1:
        raise ValueError("n_evals must be >= 1")
    if mode == "uniform":
        idx = {int(round(i * n_steps / n_evals)) for i in range(n_evals)}
    elif mode == "last":
        idx = {n_steps - 1} | {
            int(round(i * (n_steps - 1) / max(1, n_evals - 1))) for i in range(n_evals - 1)
        }
        # rounding can collide with the forced last step: backfill earlier
        # slots until the budget is spent
        i = n_steps - 2
        while len(idx) < n_evals and i > 0:
            idx.add(i)
            i -= 1
    elif mode == "front":
        idx = set(range(n_evals))
    elif mode == "tail":
        idx = {0} | set(range(n_steps - (n_evals - 1), n_steps))
    else:
        raise ValueError(f"unknown refresh mode {mode!r}")
    idx.add(0)
    return tuple(sorted(idx))


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
