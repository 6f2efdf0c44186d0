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
- per-epoch PSNR/SSIM validation with the canonical metrics;
- BatchNorm statistics (the expert trainer, ``has_batch_stats``): the
  model's running buffers, which every train-mode forward moves, a skipped
  batch's too, as the JAX step returns them unconditionally; validation and
  the saved ``.pth`` use them;
- frozen modules (the hybrid trainer's backends, ``frozen``): on the device
  in eval mode with no gradient, outside the optimizer, the clip and the
  saved ``state_dict``, passed to the loss and eval functions as their last
  argument.

The random draws of a step (the diffusion trainers' t and eps) come from a
``torch.Generator`` on the training device, seeded from ``cfg.seed``,
through a draw function of their own, so that a test can feed the JAX
package's draws instead.

``TrainConfig.remat`` recomputes the whole loss function in the backward
pass (``torch.utils.checkpoint``), as the JAX trainer wraps its loss in
``jax.checkpoint``. ``TrainConfig.mesh_shape = (dp, sp, tp)`` trains over
dp x sp x tp ranks, one process each (``parallel/``): every rank starts
from rank 0's weights; at tp > 1 it then keeps its tp slice of each
parameter that ``param_shardings(model, tp, cfg.tp_min_size)`` splits
(``parallel.tp.shard_over_group``), at sp > 1 it computes its block of
each convolution's output rows (``parallel.sp.shard_rows_over_group``),
with the whole weights, or, at sp and tp > 1 together, with its tp slice
of a split layer's (the row split wraps the tp split); every rank draws for the
global batch and keeps its dp group's rows (``image_sharding``: the rows of
a dp group, replicated over sp and tp), loads only those rows of each
global batch, and applies the update of the global batch
(``parallel.train_dp``); validation runs on every rank (a tp split forward
needs every rank; an sp one computes whole on each, as the JAX trainer's
eval runs replicated over sp) and rank 0's numbers decide; rank 0 writes the ``.pth``
in the single-process layout (the unsharded ``state_dict`` and AdamW's
state gathered slice by slice), so a checkpoint resumes at any (dp, sp,
tp), and each rank slices what it holds. Frozen modules (the hybrid's
backends) run whole on every rank.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from midd_tpu_torch.diffusion.sampler import denoise, noise_images, sample_timesteps
from midd_tpu_torch.diffusion.schedule import Schedule
from midd_tpu_torch.models.blocks import BatchNorm2d
from midd_tpu_torch.models.hybrid import hybrid_forward
from midd_tpu_torch.parallel.mesh import check_mesh_shape, image_sharding, make_mesh, replicated
from midd_tpu_torch.parallel.multihost import local_device
from midd_tpu_torch.parallel.sp import shard_rows_over_group
from midd_tpu_torch.parallel.tp import shard_over_group
from midd_tpu_torch.parallel.train_dp import make_sharded_train_step, sp_group, tp_group
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
    # rematerialise the loss's forward in the backward pass
    remat: bool = False
    # (dp, sp, tp): data parallel over dp, spatial over sp, tensor parallel
    # over tp, one process a rank (the process group started)
    mesh_shape: Optional[Tuple[int, int, int]] = None
    tp_min_size: int = 1 << 16  # the JAX trainer's tp threshold: smaller parameters stay whole


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


def global_norm(grads: List[torch.Tensor], sliced: Optional[List[bool]] = None, group=None) -> torch.Tensor:
    """The norm of all gradients together. With a tp ``group``, the
    gradients flagged in ``sliced`` are this rank's slices of split
    parameters: their squares are summed over the group and the others
    (replicated on every rank) counted once, which is the norm of the
    whole, unsharded gradient, as ``optax.clip_by_global_norm`` sees it."""
    if group is None:
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    squares = [torch.linalg.vector_norm(g).square() for g in grads]
    zero = torch.zeros_like(squares[0])
    split = torch.stack([q for q, s in zip(squares, sliced) if s] or [zero]).sum()
    whole = torch.stack([q for q, s in zip(squares, sliced) if not s] or [zero]).sum()
    dist.all_reduce(split, group=group)
    return (split + whole).sqrt()


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, sliced: Optional[List[bool]] = None,
                         group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: g <- g * min(1, max_norm/||g||)
    over all gradients together (``global_norm``). Returns the norm before
    clipping."""
    norm = global_norm(grads, sliced, group)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)
    return norm


def finite_update(loss: torch.Tensor, params: List[nn.Parameter],
                  optimizer: torch.optim.Optimizer, grad_clip: float,
                  sliced: Optional[List[bool]] = None, tp_group=None) -> bool:
    """Apply the clipped optimizer update from the parameters' ``.grad`` only
    when ``loss`` is finite; otherwise leave the parameters and the
    optimizer's state (moments, step count) untouched. Returns whether the
    update was applied. Reading the loss waits for the device. ``sliced``
    and ``tp_group``: which of ``params`` are this rank's slices of
    parameters split over the tp group (``global_norm``)."""
    if not bool(torch.isfinite(loss)):
        return False
    held = [(p.grad, s) for p, s in zip(params, sliced or [False] * len(params)) if p.grad is not None]
    clip_by_global_norm_([g for g, _ in held], grad_clip, [s for _, s in held], tp_group)
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


def cddpm_loss_fn() -> Callable:
    """loss(model, batch, draw) -> (loss, parts) of the cddpm trainer
    (cddpm/cddpmModels.py:372-374): plain MSE between the predicted and the
    drawn eps, with no clamp and no edge term; its draw is
    ``diffusion_draw``'s."""

    def fn(model: nn.Module, batch, draw):
        t, x_t, eps = draw
        return losses.mse(model(x_t, batch[1], t), eps), {}

    return fn


def tiny_draw(schedule_1000: Schedule) -> Callable:
    """draw(batch, generator) -> (t, x_t, eps) of the TinyUNet trainer: t
    uniform in [0, noise_steps) and the clean image, moved to [-1, 1],
    forward-noised on the 1000-step schedule (fastmodeltraining.py:27-49)."""

    def draw(batch, generator: torch.Generator):
        clean = batch[0] * 2.0 - 1.0
        t = torch.randint(0, schedule_1000.noise_steps, (clean.shape[0],), generator=generator,
                          device=generator.device)
        x_t, eps = noise_images(clean, t, schedule_1000, generator)
        return t, x_t, eps

    return draw


def tiny_loss_fn() -> Callable:
    """loss(model, batch, draw) -> (loss, parts) of the TinyUNet trainer: the
    prediction ``model(x_t, t, noisy)``, with the noisy image in [-1, 1],
    against the drawn noise (``losses.combined_loss_tiny``)."""

    def fn(model: nn.Module, batch, draw):
        noisy = batch[1] * 2.0 - 1.0
        t, x_t, eps = draw
        return losses.combined_loss_tiny(model(x_t, t, noisy), eps), {}

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
# The expert and the hybrid router: losses on the direct prediction
# ---------------------------------------------------------------------------


def expert_loss_fn(dead_grad_ssim: bool = False, perceptual_weight: float = 0.3,
                   loss_variant: str = "reference") -> Callable:
    """loss(model, batch, draw) -> (loss, parts) on the clamped train-mode
    prediction (DirectUNet:339): "reference" is the HybridLoss
    (``losses.hybrid_loss_expert``), "l2" pure MSE. The forward moves the
    BatchNorm running statistics."""
    if loss_variant not in ("reference", "l2"):
        raise ValueError(f"loss_variant must be 'reference' or 'l2', got {loss_variant!r}")

    def fn(model: nn.Module, batch, draw):
        clean, noisy = batch
        pred = model(noisy).clamp(0.0, 1.0)
        if loss_variant == "l2":
            return losses.mse(pred, clean), {}
        return losses.hybrid_loss_expert(pred, clean, dead_grad_ssim=dead_grad_ssim,
                                         perceptual_weight=perceptual_weight), {}

    return fn


def hybrid_apply(model: nn.Module, frozen: Dict[str, nn.Module], noisy: torch.Tensor,
                 schedule: Schedule, diffusion_steps: int) -> torch.Tensor:
    """The hybrid graph of a ``RouterFusion`` ``model`` on the ``frozen``
    backends {"nafnet", "unet"[, "expert"]}: the rollout runs
    ``diffusion_steps`` steps, every one fresh, in the UNet's dtype."""
    unet = frozen["unet"]
    return hybrid_forward(
        frozen["nafnet"],
        lambda x: denoise(unet, x, schedule, diffusion_steps),
        model.router,
        model.fusion,
        noisy,
        expert_apply=frozen.get("expert"),
    )


def hybrid_loss_fn(schedule: Schedule, diffusion_steps: int,
                   loss_variant: str = "reference") -> Callable:
    """loss(model, batch, draw, frozen) -> (loss, parts) of the hybrid
    (hybrid3diffusionspeed.py:613-620,669): the frozen backends run without
    gradient, the router and the fusion of ``model`` carry it. "reference"
    is the PerceptualLoss (``losses.perceptual_loss_hybrid``), "l2" pure
    MSE."""
    if loss_variant not in ("reference", "l2"):
        raise ValueError(f"loss_variant must be 'reference' or 'l2', got {loss_variant!r}")

    def fn(model: nn.Module, batch, draw, frozen):
        clean, noisy = batch
        pred = hybrid_apply(model, frozen, noisy, schedule.to(noisy.device), diffusion_steps)
        if loss_variant == "l2":
            return losses.mse(pred, clean), {}
        return losses.perceptual_loss_hybrid(pred, clean), {}

    return fn


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _buffers_held(model: nn.Module):
    """Keep ``model``'s BatchNorm buffers still while its forward runs again."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_buffers = False
    try:
        yield
    finally:
        for m in norms:
            m.update_buffers = True


def rematerialise(loss_fn: Callable) -> Callable:
    """``loss_fn`` whose forward keeps no activations: the backward pass runs
    it again (``torch.utils.checkpoint``, non-reentrant), the whole loss
    function as one region, as the JAX trainer's ``jax.checkpoint(loss_fn)``.
    The draws are arguments, so the second run sees the same ones; the
    BatchNorm buffers move in the first run only."""

    def fn(model: nn.Module, *args):
        return checkpoint(loss_fn, model, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), _buffers_held(model)))

    return fn


# ---------------------------------------------------------------------------
# The training engine
# ---------------------------------------------------------------------------


class Trainer:
    """Epoch loop with validation, best checkpoints, resume and early
    stopping, on one device, or on each of dp x sp x tp ranks
    (``cfg.mesh_shape``; ``device`` "cuda" is then each rank's own card, or
    the card the ranks share). At sp or tp > 1 ``state.model`` is this
    rank's split module and ``shards`` its map to the unsharded one
    (``state_dicts`` gives the unsharded state).

    ``loss_fn(model, batch, draw) -> (loss, parts)``, ``draw_fn(batch,
    generator) -> draw`` and ``eval_fn(model, extra, clean, noisy) -> pred``
    take NCHW tensors on ``device``.

    ``has_batch_stats``: the model carries BatchNorm running statistics (its
    buffers, saved with it). The buffers move in every train-mode forward
    whatever the flag says, so the flag must say whether the model holds a
    BatchNorm, and a model that disagrees is refused. ``frozen``: a dict of
    modules that the loss and eval functions take as their last argument,
    ``loss_fn(model, batch, draw, frozen)`` and ``eval_fn(model, extra,
    clean, noisy, frozen)``; they stay in eval mode with no gradient and are
    not saved. The two are mutually exclusive, as in the JAX package."""

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
        if frozen is not None and has_batch_stats:
            raise ValueError("frozen and has_batch_stats are mutually exclusive")
        has_bn = any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in model.modules())
        if has_bn != has_batch_stats:
            raise ValueError(f"has_batch_stats={has_batch_stats}, but the model "
                             f"{'holds' if has_bn else 'holds no'} BatchNorm statistics")
        self.mesh, self.rows = None, None  # dp, sp or tp > 1: the mesh, and this rank's rows of a batch
        if cfg.mesh_shape is not None:
            dp, sp, tp = check_mesh_shape(cfg.mesh_shape)
            n = dp * sp * tp
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world < n:
                raise ValueError(f"mesh_shape {cfg.mesh_shape} needs {n} devices, have {world}")
            if world > n:
                raise ValueError(f"mesh_shape {cfg.mesh_shape} needs {n} devices, but {world} ranks run")
            if cfg.batch_size % dp:
                raise ValueError(f"batch_size {cfg.batch_size} not divisible by dp={dp}")
            if n > 1:
                if torch.device(device) == torch.device("cuda") and torch.cuda.is_available():
                    device = local_device("cuda")
                self.mesh = make_mesh(n, tp=tp, sp=sp, device_type=torch.device(device).type)
                self.rows = image_sharding(cfg.batch_size, self.mesh)[:2]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer device is cuda but no CUDA device is available; "
                "pass device='cpu' to train on the CPU"
            )
        self.cfg = cfg
        self.loss_fn = rematerialise(loss_fn) if cfg.remat else loss_fn
        self.eval_fn, self.draw_fn = eval_fn, draw_fn
        model = model.to(self.device)
        if self.mesh is not None:  # every replica starts from rank 0's weights and statistics
            replicated([*model.parameters(), *model.buffers()], self.mesh)
        tp, sp = tp_group(self.mesh), sp_group(self.mesh)
        self.shards = shard_over_group(model, tp, cfg.tp_min_size) if tp is not None else None
        if sp is not None:  # the row split wraps the tp split, and extends its map
            self.shards = shard_rows_over_group(model, sp, self.shards)
        self.frozen = None if frozen is None else {
            k: m.to(self.device).eval().requires_grad_(False) for k, m in frozen.items()
        }
        self._frozen_args = () if frozen is None else (self.frozen,)
        # the trained parameters, in the unsharded model's order (a
        # single-process optimizer's indices, which the checkpoint keeps)
        self.params = (self.shards.params() if self.shards is not None
                       else [p for p in model.parameters() if p.requires_grad])
        self.state = TrainerState(model=model, optimizer=make_optimizer(cfg, self.params),
                                  extra=extra or {})
        self._step = make_sharded_train_step(self.loss_fn, self.state.optimizer, model, self.mesh, cfg.grad_clip,
                                             self.shards)
        self.schedule = lr_schedule_per_epoch(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    @property
    def is_main(self) -> bool:
        """Whether this process writes checkpoints and logs (rank 0)."""
        return self.mesh is None or dist.get_rank() == 0

    def _draw(self, batch: Tuple[torch.Tensor, ...]):
        """The step's draws for ``batch``. Under a mesh, drawn for the
        global batch (this rank's rows in place, zeros elsewhere) from the
        one seeded generator, and this rank's rows kept, so that every rank
        draws what the single-process step draws (the tp ranks of a dp
        group the same)."""
        if self.rows is None:
            return self.draw_fn(batch, self.generator)
        start, n = self.rows
        full = []
        for t in batch:
            g = t.new_zeros((self.cfg.batch_size, *t.shape[1:]))
            g[start : start + n] = t
            full.append(g)
        draw = self.draw_fn(tuple(full), self.generator)
        return None if draw is None else tuple(d[start : start + n] for d in draw)

    def train_step(self, batch: Tuple[torch.Tensor, torch.Tensor]) -> float:
        """One update on a device batch (under dp, this rank's rows of the
        global batch); returns the global batch's loss (NaN/inf for a
        skipped batch, whose forward still moved any BatchNorm statistics)."""
        return float(self._step(batch, self._draw(batch), *self._frozen_args))

    @torch.no_grad()
    def validate(self, val_samples: List[Tuple[np.ndarray, np.ndarray]]) -> Tuple[float, float]:
        """Mean (PSNR, SSIM) of the clamped predictions over the finite
        ones; (0, 0) when none is finite. Under a mesh every rank validates
        (a split forward needs every rank of its tp group) and rank 0's
        numbers are returned on all, so that every rank takes the
        same checkpoint and early-stopping decisions."""
        st = self.state
        st.model.eval()
        psnrs, ssims = [], []
        for vc, vn in val_samples:
            clean, noisy = to_device((vc[None], vn[None]), self.device)
            pred = self.eval_fn(st.model, st.extra, clean, noisy, *self._frozen_args)
            p, s = compute_metrics(pred.clamp(0.0, 1.0), clean)
            if math.isfinite(float(p)):
                psnrs.append(float(p))
                ssims.append(float(s))
        result = (float(np.mean(psnrs)), float(np.mean(ssims))) if psnrs else (0.0, 0.0)
        if self.mesh is not None:
            shared = torch.tensor(result, dtype=torch.float64, device=self.device)
            dist.broadcast(shared, src=0)
            result = tuple(shared.tolist())
        return result

    def resume(self, ckpt_path: str) -> None:
        """Full resume from a checkpoint written by ``save``, at any (dp,
        sp, tp): weights, optimizer state, epoch, best metrics and
        histories (each rank loads its tp slices)."""
        ckpt = load_checkpoint(ckpt_path)
        st = self.state
        if self.shards is None:
            st.model.load_state_dict(ckpt["model_state_dict"], strict=True)
        else:
            self.shards.load_full_state_dict(ckpt["model_state_dict"])
        if "optimizer_state_dict" in ckpt:
            opt = ckpt["optimizer_state_dict"]
            st.optimizer.load_state_dict(opt if self.shards is None else self.shards.sliced_optimizer_state(opt))
        st.epoch = int(ckpt.get("epoch", -1)) + 1
        st.best_psnr = float(ckpt.get("best_psnr", 0.0))
        st.best_ssim = float(ckpt.get("best_ssim", 0.0))
        for k in st.history:
            st.history[k] = list(ckpt.get(k, []))

    def state_dicts(self) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(model, optimizer) ``state_dict``s in the single-process layout:
        under sp or tp the unsharded keys, and at tp > 1 the parameters and
        AdamW's state gathered slice by slice over the tp group (every rank
        must call it then)."""
        st = self.state
        if self.shards is None:
            return st.model.state_dict(), st.optimizer.state_dict()
        return self.shards.full_state_dict(), self.shards.full_optimizer_state(st.optimizer.state_dict())

    def save(self, metadata: Optional[Dict] = None) -> str:
        """Write ``<ckpt_dir>/<ckpt_name>.pth`` (under a mesh, every rank
        calls it, rank 0 writes it and every rank returns once it is
        written); returns its path."""
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
            *self.state_dicts(), meta,
            replicas=None if self.mesh is None else dist.group.WORLD,
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
                                 seed=cfg.seed + epoch, num_workers=cfg.num_workers, rows=self.rows)
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

            if verbose and self.is_main:
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
                if verbose and self.is_main:
                    print("early stopping")
                break

        return st


def plot_training_curves(history: Dict[str, List[float]], out_path: str) -> bool:
    """Loss/PSNR/SSIM curve PNG, as every reference trainer saves
    (DDIM:440-464). Without matplotlib it writes nothing and returns False:
    the curves are a by-product and never stop a run. Under data
    parallelism rank 0 writes them."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return False
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
