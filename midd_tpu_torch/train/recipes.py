"""Training recipes of the port (counterpart of ``midd_tpu/train/recipes.py``).

Ported: ``train_diffusion`` (DDIM/DDIMModel.py:302-468: epochs 30, bs 1,
lr 2e-4, cosine to lr/100, eps-MSE + 0.2 edge-on-x0) and its CLI. The other
recipes (nafnet, cddpm, expert, hybrid, tiny) are ROADMAP.md queue 1 item 13;
asking for them exits non-zero.

Fresh weights come from the port's seeded ``init_weights`` (flax's
initialisers cannot be reproduced bit for bit). The best checkpoint is
``<ckpt_dir>/diffusion.pth`` in the reference's format, with the flattened
arch fields and ``noise_steps``, which the port's serving engine reads.

CLI:
    python -m midd_tpu_torch.train.recipes --model diffusion \\
        --clear-dir data/clean --noisy-dirs data/noisy [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from midd_tpu_torch import config
from midd_tpu_torch.diffusion.sampler import denoise
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.train.data import PairedXRayDataset
from midd_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainerState,
    diffusion_draw,
    diffusion_loss_fn,
    plot_training_curves,
)

MODELS = ("nafnet", "diffusion", "cddpm", "expert", "hybrid", "tiny")
TINY_UNET = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1,), time_emb_dim=16)  # the JAX CLI's --preset tiny


def _val_samples(dataset, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Hold out the first n samples like the reference trainers (DDIM uses 1)."""
    return [dataset[i] for i in range(min(n, len(dataset)))]


def default_train_config() -> TrainConfig:
    return TrainConfig(epochs=30, batch_size=1, lr=2e-4, weight_decay=1e-4,
                       ckpt_name="diffusion")


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
    ap.add_argument("--preset", choices=["full", "tiny"], default="full",
                    help="tiny = smoke-test widths")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.model != "diffusion":
        ap.error(f"--model {args.model}: only the diffusion recipe is ported; the "
                 f"others are ROADMAP.md queue 1 item 13")

    dataset = PairedXRayDataset(args.clear_dir, args.noisy_dirs, img_size=args.img_size,
                                max_samples=args.max_samples)
    overrides = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                                   ("lr", args.lr)) if v}
    cfg = dataclasses.replace(default_train_config(), **overrides)
    mc = config.DiffusionUNetConfig(**TINY_UNET) if args.preset == "tiny" else config.SERVE_DIFFUSION
    return train_diffusion(dataset, model_cfg=mc, train_cfg=cfg, resume=args.resume,
                           device=args.device)


if __name__ == "__main__":
    main()
