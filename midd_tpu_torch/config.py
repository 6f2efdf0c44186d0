"""Configuration dataclasses and serving presets of the port.

A copy of the parts of ``midd_tpu/config.py`` that the port runs (the port
imports nothing of ``midd_tpu``). The presets are the literals the reference
service hard-codes (run.py:34-74).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class DiffusionUNetConfig:
    """Conditional epsilon-prediction UNet (DDIM/DDIMModel.py:168-217 and the
    cddpm variant cddpm/cddpmModels.py:176-230). ``skip_mode``: "ddim" puts
    attention after every ResBlock at the attention resolutions, "cddpm"
    only after the first up-ResBlock of each of them."""

    in_channels: int = 1
    model_channels: int = 48
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (3,)
    dropout: float = 0.0
    time_emb_dim: int = 192
    skip_mode: str = "ddim"  # "ddim" | "cddpm"


@dataclass(frozen=True)
class NAFNetConfig:
    """EnhancedNAFNet (NafNet/NafnetModel.py:232-309) and the model2 variant
    (Backend/model2.py:75-153: multiscale intro convs + additive skips, no
    skip_convs)."""

    img_channel: int = 1
    width: int = 32
    middle_blk_num: int = 8
    enc_blk_nums: Tuple[int, ...] = (2, 2, 4, 6)
    dec_blk_nums: Tuple[int, ...] = (2, 2, 2, 2)
    multiscale_intro: bool = False  # model2.py:109-127
    additive_skips: bool = False  # model2.py:138-141 (True => no skip_convs)

    @property
    def padder_size(self) -> int:
        return 2 ** len(self.enc_blk_nums)


@dataclass(frozen=True)
class ExpertConfig:
    """ExpertDenoiser / DirectUNet (DirectUNet/DirectUNetModel.py:160-255)."""

    in_channels: int = 1
    base_channels: int = 64


@dataclass(frozen=True)
class RouterConfig:
    """NoiseAnalyzer routing-mask UNet (hybrid3diffusionspeed.py:470-534)."""

    in_c: int = 1
    out_c: int = 1
    base_c: int = 32


@dataclass(frozen=True)
class FusionConfig:
    """FusionModule (hybrid3diffusionspeed.py:537-557). ``residual``: the
    zero-initialised 1x1 head predicts a correction added to the NAFNet
    branch. ``sees_expert``: the fusion also takes the ExpertDenoiser
    branch as a fourth input."""

    in_c: int = 3
    out_c: int = 1
    base_c: int = 48
    residual: bool = False
    sees_expert: bool = False


@dataclass(frozen=True)
class ScheduleConfig:
    """Linear beta schedule (DDIM/DDIMModel.py:251-257)."""

    noise_steps: int = 50
    beta_start: float = 1e-4
    beta_end: float = 0.02


@dataclass(frozen=True)
class TinyUNetConfig:
    """TinyUNet fast experimental model (newfastmodel/modelfunctions.py:111-164)."""

    in_ch: int = 2
    base_ch: int = 32
    time_dim: int = 64


@dataclass(frozen=True)
class HybridConfig:
    """HybridDenoisingRouter composition (hybrid3diffusionspeed.py:560-628)."""

    nafnet: NAFNetConfig = field(default_factory=NAFNetConfig)
    diffusion: DiffusionUNetConfig = field(default_factory=DiffusionUNetConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    router: RouterConfig = field(default_factory=RouterConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    expert: ExpertConfig = field(default_factory=ExpertConfig)
    training_diffusion_steps: int = 10
    inference_diffusion_steps: int = 10


SERVE_DIFFUSION = DiffusionUNetConfig()
SERVE_NAFNET = NAFNetConfig()
SERVE_EXPERT = ExpertConfig()
SERVE_SCHEDULE = ScheduleConfig()
SERVE_HYBRID = HybridConfig(training_diffusion_steps=8, inference_diffusion_steps=8)
SERVE_IMG_SIZE = 512  # run.py:198
SERVE_DIFFUSION_STEPS = 8  # run.py:107

# Residual, expert-fed fusion profile of the JAX package (same param tree as
# the reference head plus one input channel).
TPU_HYBRID = HybridConfig(
    fusion=FusionConfig(residual=True, sees_expert=True),
    training_diffusion_steps=8,
    inference_diffusion_steps=8,
)

# Secondary model families.
CDDPM_UNET = DiffusionUNetConfig(skip_mode="cddpm")
TINY_UNET = TinyUNetConfig()
MODEL2_NAFNET = NAFNetConfig(
    width=24,
    enc_blk_nums=(1, 2, 2, 4),
    dec_blk_nums=(1, 1, 2, 2),
    middle_blk_num=8,
    multiscale_intro=True,
    additive_skips=True,
)
