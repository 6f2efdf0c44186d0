"""Training recipes of the port (counterpart of ``midd_tpu/train/recipes.py``).

Ported, with the reference's hyperparameters and their CLI:

- ``train_diffusion`` (DDIM/DDIMModel.py:302-468: epochs 30, bs 1, lr 2e-4,
  cosine to lr/100, eps-MSE + 0.2 edge-on-x0);
- ``train_nafnet`` (NafNet/NafnetModel.py: epochs 50, bs 2, lr 2e-4, wd 1e-4,
  5 warmup epochs, CombinedLoss or pure MSE);
- ``train_expert`` (DirectUNet/DirectUNetModel.py:281-421: epochs 70, bs 4,
  lr 1e-4, wd 1e-5, 5 warmup epochs, HybridLoss or pure MSE, BatchNorm
  statistics);
- ``train_hybrid`` (hybrid3diffusionspeed.py:631-876: epochs 50, bs 6,
  lr 4e-4, cosine to lr/50, PerceptualLoss or pure MSE, frozen NAFNet and
  diffusion backends (and the expert where the fusion sees it), patience 20,
  5 validation samples);
- ``train_cddpm`` (cddpm/cddpmModels.py:321-468: epochs 30, bs 1, lr 2e-4,
  wd 1e-4, the cddpm-mode UNet, plain eps-MSE, validated by the ancestral
  rollout);
- ``train_tiny`` (newfastmodel/fastmodeltraining.py:23-79: epochs 18, bs 4,
  lr 1.5e-4, wd 1e-6, the TinyUNet on the 1000-step schedule, loss against
  the noise, validated by the 12-step DDPM rollout).

Fresh weights come from the port's seeded ``init_weights`` (flax's
initialisers cannot be reproduced bit for bit). The best checkpoint is
``<ckpt_dir>/<model>.pth`` in the reference's format, with the flattened
arch fields (and ``noise_steps`` for the diffusion UNet), or for the hybrid
the nested ``nafnet_params``, ``diffusion_params``, ``router_params``,
``fusion_params`` (and ``expert_params``) and only the router and fusion
weights; the port's serving engine reads each of them. Before training, the
CLI draws the dataset's first pairs into ``dataset_validation_pairs.png``
(``data.visualize_pairs``, on rank 0; skipped with a line where matplotlib
is missing, as the JAX CLI does).

CLI:
    python -m midd_tpu_torch.train.recipes --model diffusion|nafnet|expert|hybrid|cddpm|tiny \\
        --clear-dir data/clean --noisy-dirs data/noisy [--device cuda|cpu] \\
        [--nafnet-ckpt N.pth --diffusion-ckpt D.pth] [--mesh DP,SP,TP] ...

Data parallel over two ranks, dp 2 x tp 2 or dp 2 x sp 2 over four (one
process a rank; gloo on the CPU, or when the ranks share a card; NCCL when
each has its own). At tp > 1 each rank holds its slice of the convolutions
that the JAX rule splits (``TrainConfig.tp_min_size``); at sp > 1 each rank
computes its block of every convolution's output rows; either way the
``.pth`` is written in the single-process layout. sp and tp together are
not ported yet (ROADMAP.md queue 1 item 15d):
    torchrun --nproc_per_node 2 -m midd_tpu_torch.train.recipes --mesh 2,1,1 ...
    torchrun --nproc_per_node 4 -m midd_tpu_torch.train.recipes --mesh 2,1,2 ...
    torchrun --nproc_per_node 4 -m midd_tpu_torch.train.recipes --mesh 2,2,1 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from midd_tpu_torch import config
from midd_tpu_torch.diffusion.ddpm_scheduler import DDPMScheduler
from midd_tpu_torch.diffusion.sampler import denoise
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import RouterFusion
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.tiny_unet import TinyUNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.parallel.mesh import check_mesh_shape
from midd_tpu_torch.parallel.multihost import init_distributed
from midd_tpu_torch.train.data import PairedXRayDataset, visualize_pairs
from midd_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainerState,
    cddpm_loss_fn,
    diffusion_draw,
    diffusion_loss_fn,
    expert_loss_fn,
    hybrid_apply,
    hybrid_loss_fn,
    nafnet_loss_fn,
    no_draw,
    plot_training_curves,
    tiny_draw,
    tiny_loss_fn,
)
from midd_tpu_torch.utils.checkpoint import load_checkpoint, orbax_message

MODELS = ("nafnet", "diffusion", "cddpm", "expert", "hybrid", "tiny")
# the JAX CLI's --preset tiny
TINY_UNET = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1,), time_emb_dim=16)
TINY_NAFNET = config.NAFNetConfig(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
TINY_EXPERT = config.ExpertConfig(base_channels=8)
TINY_HYBRID = config.HybridConfig(
    nafnet=TINY_NAFNET,
    diffusion=config.DiffusionUNetConfig(**TINY_UNET),
    router=config.RouterConfig(base_c=8),
    fusion=config.FusionConfig(base_c=16),
    training_diffusion_steps=3,
    inference_diffusion_steps=3,
)
BACKEND_SEED = 7  # a backend with no checkpoint: seeded weights, as JAX's PRNGKey(7)


def _val_samples(dataset, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Hold out the first n samples like the reference trainers (DDIM uses 1)."""
    return [dataset[i] for i in range(min(n, len(dataset)))]


_DEFAULTS = {
    "nafnet": dict(epochs=50, batch_size=2, lr=2e-4, weight_decay=1e-4, warmup_epochs=5),
    "diffusion": dict(epochs=30, batch_size=1, lr=2e-4, weight_decay=1e-4),
    "expert": dict(epochs=70, batch_size=4, lr=1e-4, weight_decay=1e-5, warmup_epochs=5),
    "hybrid": dict(epochs=50, batch_size=6, lr=4e-4, weight_decay=1e-4, eta_min_factor=0.02,
                   patience=20),
    "cddpm": dict(epochs=30, batch_size=1, lr=2e-4, weight_decay=1e-4),
    "tiny": dict(epochs=18, batch_size=4, lr=1.5e-4, weight_decay=1e-6),
}


def default_train_config(model: str = "diffusion") -> TrainConfig:
    """The JAX CLI's defaults for a recipe (``recipes.py:510-525``)."""
    return TrainConfig(**_DEFAULTS[model], ckpt_name=model)


def _load_backend(ckpt: Optional[str], model: nn.Module, name: str, seeded: List[str]) -> nn.Module:
    """A frozen backend's weights: a port (or reference) ``.pth`` loads
    strictly; no path, or a path that does not exist, gives seeded weights,
    as the JAX package falls back to a seeded init: that is printed and
    ``name`` joins ``seeded``. An orbax directory raises, naming the
    converter (``orbax_bridge.py``)."""
    if ckpt and os.path.isdir(ckpt):
        raise NotImplementedError(orbax_message(ckpt))
    if ckpt and (os.path.exists(ckpt) or os.path.exists(ckpt + ".pth")):
        state = load_checkpoint(ckpt)
        model.load_state_dict(state.get("model_state_dict", state), strict=True)
        return model
    print(f"{name} backend: no checkpoint at {ckpt!r}; seeded random weights (seed {BACKEND_SEED})",
          flush=True)
    seeded.append(name)
    return init_weights(model, torch.Generator().manual_seed(BACKEND_SEED))


def train_nafnet(
    dataset,
    model_cfg: config.NAFNetConfig = config.SERVE_NAFNET,
    train_cfg: Optional[TrainConfig] = None,
    resume: Optional[str] = None,
    loss_variant: str = "reference",
    init_from: Optional[str] = None,
    device: str = "cuda",
) -> TrainerState:
    """``loss_variant``: "reference" (CombinedLoss) or "l2" (pure MSE).
    ``init_from``: a port ``.pth`` to take the parameters from, with a fresh
    optimizer, epoch and schedule (a fine-tune; ``resume`` restores the
    whole training state)."""
    cfg = train_cfg or default_train_config("nafnet")
    model = init_weights(EnhancedNAFNet(model_cfg), torch.Generator().manual_seed(cfg.seed))
    if init_from:
        model.load_state_dict(load_checkpoint(init_from)["model_state_dict"], strict=True)
    trainer = Trainer(
        loss_fn=nafnet_loss_fn(loss_variant),
        eval_fn=lambda model, extra, clean, noisy: model(noisy),
        cfg=cfg,
        model=model,
        draw_fn=no_draw,
        device=device,
    )
    if resume:
        trainer.resume(resume)
    state = trainer.fit(dataset, _val_samples(dataset, 1), metadata=dataclasses.asdict(model_cfg))
    plot_training_curves(state.history, "nafnet_training_curves.png")
    return state


def train_diffusion(
    dataset,
    model_cfg: config.DiffusionUNetConfig = config.SERVE_DIFFUSION,
    schedule_cfg: config.ScheduleConfig = config.SERVE_SCHEDULE,
    train_cfg: Optional[TrainConfig] = None,
    resume: Optional[str] = None,
    val_inference_steps: int = 15,  # DDIM:415
    device: str = "cuda",
) -> TrainerState:
    cfg = train_cfg or default_train_config()
    model = init_weights(UNetDiffusion(model_cfg), torch.Generator().manual_seed(cfg.seed))
    schedule = make_schedule(schedule_cfg, device)

    def eval_fn(model, extra, clean, noisy):
        return denoise(model, noisy, schedule, val_inference_steps)

    trainer = Trainer(
        loss_fn=diffusion_loss_fn(schedule),
        eval_fn=eval_fn,
        cfg=cfg,
        model=model,
        draw_fn=diffusion_draw(schedule),
        device=device,
    )
    if resume:
        trainer.resume(resume)
    state = trainer.fit(
        dataset,
        _val_samples(dataset, 1),
        metadata={**dataclasses.asdict(model_cfg), "noise_steps": schedule_cfg.noise_steps},
    )
    plot_training_curves(state.history, "diffusion_training_curves.png")
    return state


def train_expert(
    dataset,
    model_cfg: config.ExpertConfig = config.SERVE_EXPERT,
    train_cfg: Optional[TrainConfig] = None,
    resume: Optional[str] = None,
    dead_grad_ssim: bool = False,
    perceptual_weight: float = 0.3,
    loss_variant: str = "reference",
    init_from: Optional[str] = None,
    device: str = "cuda",
) -> TrainerState:
    """``loss_variant``: "reference" (HybridLoss: L1 + 0.4 (1 - SSIM) +
    ``perceptual_weight`` x the random-feature distance; ``dead_grad_ssim``
    detaches the SSIM term, as the reference's numpy SSIM) or "l2" (pure
    MSE). ``init_from``: a port ``.pth`` to take the parameters and the
    BatchNorm statistics from, with a fresh optimizer, epoch and schedule."""
    cfg = train_cfg or default_train_config("expert")
    model = init_weights(ExpertDenoiser(model_cfg), torch.Generator().manual_seed(cfg.seed))
    if init_from:
        model.load_state_dict(load_checkpoint(init_from)["model_state_dict"], strict=True)
    trainer = Trainer(
        loss_fn=expert_loss_fn(dead_grad_ssim, perceptual_weight, loss_variant),
        eval_fn=lambda model, extra, clean, noisy: model(noisy),
        cfg=cfg,
        model=model,
        draw_fn=no_draw,
        has_batch_stats=True,
        device=device,
    )
    if resume:
        trainer.resume(resume)
    state = trainer.fit(dataset, _val_samples(dataset, 1), metadata=dataclasses.asdict(model_cfg))
    plot_training_curves(state.history, "expert_training_curves.png")
    return state


def train_hybrid(
    dataset,
    nafnet_ckpt: Optional[str],
    diffusion_ckpt: Optional[str],
    hybrid_cfg: config.HybridConfig = config.HybridConfig(),
    train_cfg: Optional[TrainConfig] = None,
    resume: Optional[str] = None,
    expert_ckpt: Optional[str] = None,
    loss_variant: str = "reference",
    device: str = "cuda",
) -> TrainerState:
    """The router and the fusion train on frozen backends: the NAFNet and
    the diffusion UNet from their checkpoints (``_load_backend``), and the
    ``ExpertDenoiser`` from ``expert_ckpt`` where
    ``hybrid_cfg.fusion.sees_expert``. Training rolls out
    ``training_diffusion_steps`` steps, validation
    ``inference_diffusion_steps``, every one fresh, in fp32. The checkpoint
    holds the router and fusion weights and says in its metadata which
    branches it has and which backends had no checkpoint and were seeded
    (``seeded_backends``)."""
    cfg = train_cfg or default_train_config("hybrid")
    sees_expert = hybrid_cfg.fusion.sees_expert
    seeded: List[str] = []
    frozen = {
        "nafnet": _load_backend(nafnet_ckpt, EnhancedNAFNet(hybrid_cfg.nafnet), "nafnet", seeded),
        "unet": _load_backend(diffusion_ckpt, UNetDiffusion(hybrid_cfg.diffusion), "diffusion", seeded),
    }
    if sees_expert:
        frozen["expert"] = _load_backend(expert_ckpt, ExpertDenoiser(hybrid_cfg.expert), "expert", seeded)
    model = init_weights(RouterFusion(hybrid_cfg.router, hybrid_cfg.fusion),
                         torch.Generator().manual_seed(cfg.seed))
    schedule = make_schedule(hybrid_cfg.schedule, device)

    def eval_fn(model, extra, clean, noisy, frozen):
        return hybrid_apply(model, frozen, noisy, schedule, hybrid_cfg.inference_diffusion_steps)

    trainer = Trainer(
        loss_fn=hybrid_loss_fn(schedule, hybrid_cfg.training_diffusion_steps, loss_variant),
        eval_fn=eval_fn,
        cfg=cfg,
        model=model,
        draw_fn=no_draw,
        frozen=frozen,
        device=device,
    )
    if resume:
        trainer.resume(resume)
    metadata = {
        "nafnet_params": dataclasses.asdict(hybrid_cfg.nafnet),
        "diffusion_params": {**dataclasses.asdict(hybrid_cfg.diffusion),
                             "noise_steps": hybrid_cfg.schedule.noise_steps},
        "router_params": dataclasses.asdict(hybrid_cfg.router),
        "fusion_params": dataclasses.asdict(hybrid_cfg.fusion),
        **({"expert_params": dataclasses.asdict(hybrid_cfg.expert)} if sees_expert else {}),
        "seeded_backends": seeded,  # backends trained on with seeded weights, not a checkpoint
    }
    state = trainer.fit(dataset, _val_samples(dataset, 5), metadata=metadata)  # hybrid:740-744
    plot_training_curves(state.history, "hybrid_training_curves.png")
    return state


def train_cddpm(
    dataset,
    model_cfg: config.DiffusionUNetConfig = config.CDDPM_UNET,
    schedule_cfg: config.ScheduleConfig = config.SERVE_SCHEDULE,
    train_cfg: Optional[TrainConfig] = None,
    resume: Optional[str] = None,
    val_inference_steps: int = 15,
    device: str = "cuda",
) -> TrainerState:
    """The cddpm UNet on plain eps-MSE; validation runs the ancestral rollout
    (no eps clamp, 0.5-scaled posterior noise) from a generator seeded 0 on
    the device afresh at each validation, as the JAX recipe uses
    ``PRNGKey(0)`` each time, so it never advances the trainer's own."""
    cfg = train_cfg or default_train_config("cddpm")
    model = init_weights(UNetDiffusion(model_cfg), torch.Generator().manual_seed(cfg.seed))
    schedule = make_schedule(schedule_cfg, device)

    def eval_fn(model, extra, clean, noisy):
        gen = torch.Generator(device=noisy.device).manual_seed(0)
        return denoise(model, noisy, schedule, val_inference_steps, stochastic=True,
                       clamp_eps=False, generator=gen)

    trainer = Trainer(
        loss_fn=cddpm_loss_fn(),
        eval_fn=eval_fn,
        cfg=cfg,
        model=model,
        draw_fn=diffusion_draw(schedule),
        device=device,
    )
    if resume:
        trainer.resume(resume)
    return trainer.fit(dataset, _val_samples(dataset, 1),
                       metadata={**dataclasses.asdict(model_cfg),
                                 "noise_steps": schedule_cfg.noise_steps})


def train_tiny(
    dataset,
    model_cfg: config.TinyUNetConfig = config.TINY_UNET,
    train_cfg: Optional[TrainConfig] = None,
    device: str = "cuda",
) -> TrainerState:
    """The TinyUNet on the 1000-step schedule (``make_schedule``), its loss
    against the noise in [-1, 1]; validation runs ``DDPMScheduler``'s 12-step
    rollout from the noisy image in [-1, 1] with a generator seeded 0 on the
    device afresh at each validation. No resume, as in the JAX recipe."""
    cfg = train_cfg or default_train_config("tiny")
    model = init_weights(TinyUNet(model_cfg), torch.Generator().manual_seed(cfg.seed))
    schedule_1000 = make_schedule(config.ScheduleConfig(noise_steps=1000), device)
    scheduler = DDPMScheduler()

    def eval_fn(model, extra, clean, noisy):
        gen = torch.Generator(device=noisy.device).manual_seed(0)
        return (scheduler.sample(model, noisy * 2.0 - 1.0, steps=12, generator=gen) + 1.0) / 2.0

    trainer = Trainer(
        loss_fn=tiny_loss_fn(),
        eval_fn=eval_fn,
        cfg=cfg,
        model=model,
        draw_fn=tiny_draw(schedule_1000),
        device=device,
    )
    return trainer.fit(dataset, _val_samples(dataset, 1), metadata=dataclasses.asdict(model_cfg))


def main(argv: Optional[Sequence[str]] = None) -> TrainerState:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=MODELS)
    ap.add_argument("--clear-dir", required=True)
    ap.add_argument("--noisy-dirs", nargs="+", required=True)
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--max-samples", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--nafnet-ckpt", default=None, help="hybrid: the frozen NAFNet's .pth")
    ap.add_argument("--diffusion-ckpt", default=None, help="hybrid: the frozen UNet's .pth")
    ap.add_argument("--loss-variant", choices=["reference", "l2"], default="reference",
                    help="nafnet/expert/hybrid: the reference loss suite or pure MSE")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full",
                    help="tiny = smoke-test widths")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DP,SP,TP",
                    help="multi-chip training mesh, e.g. '4,1,1' for 4-way "
                         "data parallelism, '2,1,2' for dp2 x tp2 or '2,2,1' "
                         "for dp2 x sp2; batches shard over dp, image rows "
                         "over sp, large kernels over tp (one process a rank, "
                         "started by torchrun; sp and tp together are not "
                         "ported yet)")
    args = ap.parse_args(argv)
    if args.model == "tiny" and args.resume:
        ap.error("--model tiny: the tiny recipe takes no --resume")
    mesh_shape = None
    if args.mesh:
        mesh_shape = check_mesh_shape(args.mesh.split(","))
        init_distributed(backend="gloo" if args.device == "cpu" else None)

    dataset = PairedXRayDataset(args.clear_dir, args.noisy_dirs, img_size=args.img_size,
                                max_samples=args.max_samples,
                                substring_glob=args.model == "hybrid")
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        try:  # the pre-training sanity figure (DirectUNet:286-303); never fatal
            visualize_pairs(dataset)
        except Exception as e:  # noqa: BLE001
            print(f"(pair visualization skipped: {e})")
    overrides = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                                   ("lr", args.lr), ("mesh_shape", mesh_shape)) if v}
    cfg = dataclasses.replace(default_train_config(args.model), **overrides)
    tiny = args.preset == "tiny"
    if args.model == "nafnet":
        return train_nafnet(dataset, model_cfg=TINY_NAFNET if tiny else config.SERVE_NAFNET,
                            train_cfg=cfg, resume=args.resume, loss_variant=args.loss_variant,
                            device=args.device)
    if args.model == "expert":
        return train_expert(dataset, model_cfg=TINY_EXPERT if tiny else config.SERVE_EXPERT,
                            train_cfg=cfg, resume=args.resume, loss_variant=args.loss_variant,
                            device=args.device)
    if args.model == "hybrid":
        return train_hybrid(dataset, nafnet_ckpt=args.nafnet_ckpt, diffusion_ckpt=args.diffusion_ckpt,
                            hybrid_cfg=TINY_HYBRID if tiny else config.HybridConfig(),
                            train_cfg=cfg, resume=args.resume, loss_variant=args.loss_variant,
                            device=args.device)
    if args.model == "cddpm":
        mc = config.DiffusionUNetConfig(skip_mode="cddpm", **TINY_UNET) if tiny else config.CDDPM_UNET
        return train_cddpm(dataset, model_cfg=mc, train_cfg=cfg, resume=args.resume,
                           device=args.device)
    if args.model == "tiny":
        mc = config.TinyUNetConfig(base_ch=8, time_dim=16) if tiny else config.TINY_UNET
        return train_tiny(dataset, model_cfg=mc, train_cfg=cfg, device=args.device)
    mc = config.DiffusionUNetConfig(**TINY_UNET) if tiny else config.SERVE_DIFFUSION
    return train_diffusion(dataset, model_cfg=mc, train_cfg=cfg, resume=args.resume,
                           device=args.device)


if __name__ == "__main__":
    main()
