"""The training engine of the port on one device (counterpart of
``midd_tpu/train/trainer.py``):

- AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) behind a
  global-norm clip that matches ``optax.clip_by_global_norm``: gradients are
  scaled by min(1, clip / ||g||), with no epsilon added to the norm (so not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6);
- warmup + cosine learning rate, stepped per epoch like the reference's
  torch schedulers;
- a batch whose loss is not finite leaves the parameters, the Adam moments
  and the step count untouched (DDIM:377-378, hybrid:776-777);
- best-validation-PSNR checkpoints in the reference's ``.pth`` format, full
  resume, early stopping;
- per-epoch PSNR/SSIM validation with the canonical metrics.

The random draws of a step (the diffusion trainer's t and eps) come from a
``torch.Generator`` on the training device, seeded from ``cfg.seed``,
through a draw function of their own, so that a test can feed the JAX
package's draws instead.

Not ported yet: frozen runtime arguments and BatchNorm statistics (the
hybrid and expert trainers, ROADMAP.md queue 1 item 13), rematerialisation
and multi-device meshes (queue 1 item 15).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from midd_tpu_torch.diffusion.sampler import noise_images, sample_timesteps
from midd_tpu_torch.diffusion.schedule import Schedule
from midd_tpu_torch.train import losses
from midd_tpu_torch.train.data import batches, prefetch_to_device, to_device
from midd_tpu_torch.train.metrics import compute_metrics
from midd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


@dataclass
class TrainConfig:
    epochs: int = 50
    batch_size: int = 2
    lr: float = 2e-4
    weight_decay: float = 1e-4
    warmup_epochs: int = 0
    eta_min_factor: float = 0.01  # eta_min = lr * factor (reference: lr/100)
    grad_clip: float = 1.0
    patience: Optional[int] = None  # early stopping (hybrid: 20)
    ckpt_dir: str = "checkpoints"
    ckpt_name: str = "best"
    seed: int = 42
    log_every: int = 10
    # host input pipeline: threaded batch assembly + background device prefetch
    num_workers: int = 2
    prefetch: int = 2
    # not ported yet (ROADMAP.md queue 1 item 15): must stay at these values
    remat: bool = False
    mesh_shape: Optional[Tuple[int, int, int]] = None
    tp_min_size: int = 1 << 16


def lr_schedule_per_epoch(cfg: TrainConfig) -> Callable[[int], float]:
    """Warmup (linear over warmup_epochs) + cosine to eta_min, evaluated on
    the EPOCH index (the reference steps its torch schedulers per epoch)."""

    def schedule(epoch: int) -> float:
        if cfg.warmup_epochs and epoch < cfg.warmup_epochs:
            return cfg.lr * (epoch + 1) / cfg.warmup_epochs
        span = max(1, cfg.epochs - cfg.warmup_epochs)
        t = (epoch - cfg.warmup_epochs) / span
        eta_min = cfg.lr * cfg.eta_min_factor
        return eta_min + 0.5 * (cfg.lr - eta_min) * (1 + math.cos(math.pi * t))

    return schedule


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor]) -> torch.optim.AdamW:
    """AdamW with optax.adamw's constants; the learning rate is set per epoch
    (``set_lr``) and the clip is applied by ``finite_update``."""
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: g <- g * min(1, max_norm/||g||)
    over all gradients together. Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


def finite_update(loss: torch.Tensor, params: List[nn.Parameter],
                  optimizer: torch.optim.Optimizer, grad_clip: float) -> bool:
    """Apply the clipped optimizer update from the parameters' ``.grad`` only
    when ``loss`` is finite; otherwise leave the parameters and the
    optimizer's state (moments, step count) untouched. Returns whether the
    update was applied. Reading the loss waits for the device."""
    if not bool(torch.isfinite(loss)):
        return False
    clip_by_global_norm_([p.grad for p in params if p.grad is not None], grad_clip)
    optimizer.step()
    return True


@dataclass
class TrainerState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    extra: Dict[str, Any] = field(default_factory=dict)
    epoch: int = 0
    best_psnr: float = 0.0
    best_ssim: float = 0.0
    history: Dict[str, List[float]] = field(
        default_factory=lambda: {"losses": [], "psnrs": [], "ssims": []}
    )


# ---------------------------------------------------------------------------
# The diffusion family: draws and loss
# ---------------------------------------------------------------------------


def diffusion_draw(schedule: Schedule) -> Callable:
    """draw(batch, generator) -> (t, x_t, eps): t uniform in [1, noise_steps)
    and the forward-noised clean image, as the JAX loss draws them from its
    key (``diffusion_loss_fn``)."""

    def draw(batch, generator: torch.Generator):
        clean = batch[0]
        t = sample_timesteps(generator, clean.shape[0], schedule.noise_steps)
        x_t, eps = noise_images(clean, t, schedule, generator)
        return t, x_t, eps

    return draw


def diffusion_loss_fn(schedule: Schedule) -> Callable:
    """loss(model, batch, draw) -> (loss, parts): the UNet predicts eps from
    (x_t, noisy, t); ``losses.diffusion_loss`` (DDIM/DDIMModel.py:356-375)."""

    def fn(model: nn.Module, batch, draw):
        clean, noisy = batch
        t, x_t, eps = draw
        eps_pred = model(x_t, noisy, t)
        return losses.diffusion_loss(eps_pred, eps, x_t, clean,
                                     schedule.to(clean.device).alpha_hat[t])

    return fn


# ---------------------------------------------------------------------------
# The NAFNet family: no draws, a loss on the direct prediction
# ---------------------------------------------------------------------------


def no_draw(batch, generator: torch.Generator) -> None:
    """The draw function of a loss that draws nothing (the NAFNet's)."""
    return None


def nafnet_loss_fn(loss_variant: str = "reference") -> Callable:
    """loss(model, batch, draw) -> (loss, parts) on pred = model(noisy):
    "reference" is the CombinedLoss (NafNet/NafnetModel.py:349-386), "l2"
    pure MSE (``midd_tpu/train/trainer.py::nafnet_loss_fn``)."""
    if loss_variant not in ("reference", "l2"):
        raise ValueError(f"loss_variant must be 'reference' or 'l2', got {loss_variant!r}")

    def fn(model: nn.Module, batch, draw):
        clean, noisy = batch
        pred = model(noisy)
        if loss_variant == "l2":
            return losses.mse(pred, clean), {}
        return losses.combined_loss_nafnet(pred, clean)

    return fn


# ---------------------------------------------------------------------------
# The training engine
# ---------------------------------------------------------------------------


class Trainer:
    """Epoch loop with validation, best checkpoints, resume and early
    stopping, on one device.

    ``loss_fn(model, batch, draw) -> (loss, parts)``, ``draw_fn(batch,
    generator) -> draw`` and ``eval_fn(model, extra, clean, noisy) -> pred``
    take NCHW tensors on ``device``."""

    def __init__(
        self,
        loss_fn: Callable,
        eval_fn: Callable,
        cfg: TrainConfig,
        model: nn.Module,
        draw_fn: Callable,
        extra: Optional[Dict[str, Any]] = None,
        has_batch_stats: bool = False,
        frozen: Optional[Any] = None,
        device: str = "cuda",
    ):
        if frozen is not None:
            raise NotImplementedError(
                "frozen runtime arguments (the hybrid trainer) are not ported "
                "yet: ROADMAP.md queue 1 item 13"
            )
        if has_batch_stats:
            raise NotImplementedError(
                "BatchNorm statistics in training (the expert trainer) are not "
                "ported yet: ROADMAP.md queue 1 item 13"
            )
        if cfg.remat or cfg.mesh_shape is not None:
            raise NotImplementedError(
                "remat and mesh_shape are not ported yet: ROADMAP.md queue 1 item 15"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer device is cuda but no CUDA device is available; "
                "pass device='cpu' to train on the CPU"
            )
        self.cfg = cfg
        self.loss_fn, self.eval_fn, self.draw_fn = loss_fn, eval_fn, draw_fn
        model = model.to(self.device)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.state = TrainerState(model=model, optimizer=make_optimizer(cfg, self.params),
                                  extra=extra or {})
        self.schedule = lr_schedule_per_epoch(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def train_step(self, batch: Tuple[torch.Tensor, torch.Tensor]) -> float:
        """One update on a device batch; returns the loss (NaN/inf for a
        skipped batch)."""
        st = self.state
        st.model.train()
        st.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.loss_fn(st.model, batch, self.draw_fn(batch, self.generator))
        loss.backward()
        finite_update(loss, self.params, st.optimizer, self.cfg.grad_clip)
        return float(loss.detach())

    @torch.no_grad()
    def validate(self, val_samples: List[Tuple[np.ndarray, np.ndarray]]) -> Tuple[float, float]:
        """Mean (PSNR, SSIM) of the clamped predictions over the finite
        ones; (0, 0) when none is finite."""
        st = self.state
        st.model.eval()
        psnrs, ssims = [], []
        for vc, vn in val_samples:
            clean, noisy = to_device((vc[None], vn[None]), self.device)
            pred = self.eval_fn(st.model, st.extra, clean, noisy)
            p, s = compute_metrics(pred.clamp(0.0, 1.0), clean)
            if math.isfinite(float(p)):
                psnrs.append(float(p))
                ssims.append(float(s))
        if not psnrs:
            return 0.0, 0.0
        return float(np.mean(psnrs)), float(np.mean(ssims))

    def resume(self, ckpt_path: str) -> None:
        """Full resume from a checkpoint written by ``save``: weights,
        optimizer state, epoch, best metrics and histories."""
        ckpt = load_checkpoint(ckpt_path)
        st = self.state
        st.model.load_state_dict(ckpt["model_state_dict"], strict=True)
        if "optimizer_state_dict" in ckpt:
            st.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        st.epoch = int(ckpt.get("epoch", -1)) + 1
        st.best_psnr = float(ckpt.get("best_psnr", 0.0))
        st.best_ssim = float(ckpt.get("best_ssim", 0.0))
        for k in st.history:
            st.history[k] = list(ckpt.get(k, []))

    def save(self, metadata: Optional[Dict] = None) -> str:
        """Write ``<ckpt_dir>/<ckpt_name>.pth``; returns its path."""
        st = self.state
        meta = {
            "epoch": st.epoch,
            "best_psnr": st.best_psnr,
            "best_ssim": st.best_ssim,
            **st.history,
            **(metadata or {}),
        }
        return save_checkpoint(
            os.path.join(self.cfg.ckpt_dir, f"{self.cfg.ckpt_name}.pth"),
            st.model.state_dict(), st.optimizer.state_dict(), meta,
        )

    def fit(
        self,
        dataset,
        val_samples: List[Tuple[np.ndarray, np.ndarray]],
        metadata: Optional[Dict] = None,
        verbose: bool = True,
    ) -> TrainerState:
        cfg = self.cfg
        st = self.state
        patience_counter = 0

        for epoch in range(st.epoch, cfg.epochs):
            st.epoch = epoch
            set_lr(st.optimizer, self.schedule(epoch))
            epoch_loss, count = 0.0, 0
            t0 = time.time()

            batch_iter = batches(dataset, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed + epoch, num_workers=cfg.num_workers)
            if cfg.prefetch > 0:
                batch_iter = prefetch_to_device(batch_iter, self.device, size=cfg.prefetch)
            else:
                batch_iter = (to_device(b, self.device) for b in batch_iter)

            for batch in batch_iter:
                loss_f = self.train_step(batch)
                if math.isfinite(loss_f):  # skipped batches don't poison the mean
                    epoch_loss += loss_f
                    count += 1

            avg_loss = epoch_loss / max(1, count)
            st.history["losses"].append(avg_loss)
            val_psnr, val_ssim = self.validate(val_samples)
            st.history["psnrs"].append(val_psnr)
            st.history["ssims"].append(val_ssim)

            if verbose:
                print(
                    f"epoch {epoch + 1}/{cfg.epochs} | loss {avg_loss:.6f} | "
                    f"val PSNR {val_psnr:.2f} dB | val SSIM {val_ssim:.4f} | "
                    f"{time.time() - t0:.1f}s", flush=True,
                )

            if val_psnr > st.best_psnr:
                st.best_psnr, st.best_ssim = val_psnr, val_ssim
                patience_counter = 0
                self.save(metadata)
            else:
                patience_counter += 1

            if cfg.patience is not None and patience_counter >= cfg.patience:
                if verbose:
                    print("early stopping")
                break

        return st


def plot_training_curves(history: Dict[str, List[float]], out_path: str) -> bool:
    """Loss/PSNR/SSIM curve PNG, as every reference trainer saves
    (DDIM:440-464). Without matplotlib it writes nothing and returns False:
    the curves are a by-product and never stop a run."""
    try:
        import matplotlib
    except ImportError:
        print(f"(training curves not written: matplotlib is not installed; {out_path})")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for ax, key, title in zip(
        axes, ["losses", "psnrs", "ssims"], ["Training Loss", "Validation PSNR", "Validation SSIM"]
    ):
        ax.plot(history.get(key, []), linewidth=2, marker="o", markersize=3)
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return True
