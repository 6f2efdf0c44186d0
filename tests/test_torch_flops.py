"""The port's FLOP counter (``midd_tpu_torch/utils/flops.py``) against the
JAX package's jaxpr walk (``midd_tpu/utils/flops.py``) on the same
functions, on the CPU: counts are integers and must be EQUAL, forward,
rollout, forward + backward of both training losses and the padded
estimate alike. The weights do not enter a count; the JAX side traces on
zeros, the port runs its models (the serve presets at 64²)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.diffusion import denoise as jdenoise
from midd_tpu.diffusion import make_schedule as jschedule
from midd_tpu.train import trainer as jtrainer
from midd_tpu.utils import flops as jflops
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.diffusion.sampler import denoise
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils import flops

TINY_UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1,), time_emb_dim=32)
TINY_NAFNET = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
TPU_TILE = (8, 128)
PADS = (None, TPU_TILE)


def _jax_counts(fn, *args) -> dict:
    """JAX's count of ``fn(*args)`` unpadded and at the TPU tile, from one trace."""
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return {pad: jflops._jaxpr_flops(jaxpr, pad) for pad in PADS}


def _port_counts(fn, *args) -> dict:
    """The port's count of ``fn(*args)`` unpadded and at the TPU tile, from
    one run (nested counters each see every operator)."""
    with flops.FlopCounter() as plain, flops.FlopCounter(TPU_TILE) as padded:
        fn(*args)
    return {None: plain.total, TPU_TILE: padded.total}


@functools.lru_cache(maxsize=None)
def _jax_model(kind: str, preset: str, fuse_updown: bool = False):
    """(model, variables' shapes) of a JAX model in the layout the port
    computes (s2d stage 0 off, the exact attention); the walk traces on
    shapes alone, and the parameters' do not depend on the image size, so
    they are traced once at 32²."""
    x, t = jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,), jnp.int32)
    if kind == "unet":
        cfg = jcfg.DiffusionUNetConfig(**TINY_UNET) if preset == "tiny" else jcfg.SERVE_DIFFUSION
        model = jm.UNetDiffusion(cfg, use_flash=False, fuse_updown=fuse_updown, s2d_stage0=False,
                                 quant=preset == "int8")
        args = (x, x, t)
    else:
        model = jm.EnhancedNAFNet(jcfg.NAFNetConfig(**TINY_NAFNET) if preset == "tiny" else jcfg.SERVE_NAFNET)
        args = (x,)
    return model, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))


def _port_model(kind: str, preset: str, fuse_updown: bool = False):
    if kind == "unet":
        cfg = tcfg.DiffusionUNetConfig(**TINY_UNET) if preset == "tiny" else tcfg.SERVE_DIFFUSION
        return UNetDiffusion(cfg, fuse_updown=fuse_updown, use_flash=False, quant=preset == "int8")
    return EnhancedNAFNet(tcfg.NAFNetConfig(**TINY_NAFNET) if preset == "tiny" else tcfg.SERVE_NAFNET)


@functools.lru_cache(maxsize=None)
def _forward_counts(kind: str, preset: str, size: int, fuse_updown: bool = False) -> tuple:
    """(JAX's, the port's) counts of one forward at batch 1."""
    model, v = _jax_model(kind, preset, fuse_updown)
    x, t = jax.ShapeDtypeStruct((1, size, size, 1), jnp.float32), jnp.zeros((1,), jnp.int32)
    xt, tt = torch.zeros(1, 1, size, size), torch.zeros(1, dtype=torch.long)
    net = _port_model(kind, preset, fuse_updown)
    with torch.no_grad():
        if kind == "unet":
            return _jax_counts(lambda w, a: model.apply(w, a, a, t), v, x), _port_counts(net, xt, xt, tt)
        return _jax_counts(model.apply, v, x), _port_counts(net, xt)


@pytest.mark.parametrize("lane_pad", PADS)
@pytest.mark.parametrize("fuse_updown", [False, True])
def test_tiny_unet_forward_equals_jax(fuse_updown, lane_pad):
    """Both layouts: plain (the transposed convolution counted at its
    output's resolution) and fused up/down (its 3×3 kernel derived by two
    products, in JAX's orientation for the padded estimate)."""
    want, got = _forward_counts("unet", "tiny", 16, fuse_updown)
    assert got[lane_pad] == want[lane_pad]


@pytest.mark.parametrize("steps,evals", [(8, 9), (50, 50)])
def test_rollouts_equal_jax(steps, evals):
    """The 9-step served rollout (8 inference steps, every step an eval)
    and bench.py's DDIM-50 (50 evals): that many forwards on both sides."""
    model, v = _jax_model("unet", "tiny", True)
    x = jnp.zeros((1, 16, 16, 1))
    js = jschedule(jcfg.SERVE_SCHEDULE)
    want = jflops.count_flops(lambda w, a: jdenoise(lambda b, c, t: model.apply(w, b, c, t), a, js, steps), v, x)
    xt = torch.zeros(1, 1, 16, 16)
    with torch.no_grad():
        got = flops.count_flops(denoise, _port_model("unet", "tiny", True), xt, make_schedule(tcfg.SERVE_SCHEDULE),
                                steps)
    assert got == want == evals * _forward_counts("unet", "tiny", 16, True)[1][None]


@pytest.mark.parametrize("lane_pad", PADS)
def test_tiny_nafnet_equals_jax(lane_pad):
    want, got = _forward_counts("nafnet", "tiny", 16)
    assert got[lane_pad] == want[lane_pad]


@pytest.mark.parametrize("lane_pad", PADS)
@pytest.mark.parametrize("kind", ["unet", "nafnet"])
def test_serve_presets_at_64_equal_jax(kind, lane_pad):
    """SERVE_DIFFUSION (plain layout) and SERVE_NAFNET forwards at 64²."""
    want, got = _forward_counts(kind, "serve", 64)
    assert got[lane_pad] == want[lane_pad]


def _port_step(model_kind, model, size, batch=2):
    """The forward + backward of the trainer's loss on a seeded draw."""
    clean = torch.zeros(batch, 1, size, size)
    if model_kind == "diffusion":
        schedule = make_schedule(tcfg.SERVE_SCHEDULE)
        loss_fn = ttrainer.diffusion_loss_fn(schedule)
        draw = ttrainer.diffusion_draw(schedule)((clean, clean), torch.Generator().manual_seed(0))
    else:
        loss_fn, draw = ttrainer.nafnet_loss_fn(), None

    def step():
        loss, _ = loss_fn(model, (clean, clean), draw)
        loss.backward()

    return flops.count_flops(step)


def _jax_step(model_kind, model, params, size, batch=2):
    """``bench_train.py``'s count: value_and_grad of the trainer's loss."""
    loss_fn = (jtrainer.diffusion_loss_fn(model, jschedule(jcfg.SERVE_SCHEDULE)) if model_kind == "diffusion"
               else jtrainer.nafnet_loss_fn(model))
    clean = jax.ShapeDtypeStruct((batch, size, size, 1), jnp.float32)
    return jflops.count_flops(jax.value_and_grad(loss_fn, has_aux=True), params, (clean, clean),
                              jax.random.PRNGKey(0))


@pytest.mark.parametrize("fuse_updown", [False, True])
def test_diffusion_training_step_equals_jax(fuse_updown):
    """Forward + backward of the diffusion loss (eps MSE + the Sobel edge
    term on x0): every convolution's input and weight gradients counted as
    JAX's transpose rules emit them (a stride-2 convolution's input
    gradient 4x its forward, the transposed one's a quarter), no gap."""
    model, v = _jax_model("unet", "tiny", fuse_updown)
    want = _jax_step("diffusion", model, v["params"], 16)
    assert _port_step("diffusion", _port_model("unet", "tiny", fuse_updown), 16) == want


def test_nafnet_training_step_equals_jax():
    """Forward + backward of the NAFNet's CombinedLoss (its SSIM and edge
    convolutions too; the FFT term counts nothing on either side)."""
    model, v = _jax_model("nafnet", "tiny")
    want = _jax_step("nafnet", model, v["params"], 16)
    assert _port_step("nafnet", _port_model("nafnet", "tiny"), 16) == want


@pytest.mark.parametrize("lane_pad", PADS)
def test_int8_unet_equals_jax(lane_pad):
    """The int8 UNet's products (``_int_mm`` on the card, its float64 plain
    version here) count as JAX counts its int8 ``dot_general``."""
    want, got = _forward_counts("unet", "int8", 16)
    assert got[lane_pad] == want[lane_pad]


def test_phase_20_constants_equal_jax():
    """``chip_smoke.py`` phase 20 holds the card's counts at 256² to these
    constants: JAX's counts of the same functions (the plain layout;
    ``bench.py``'s DDIM-50 rollout is 50 forwards, test_rollouts_equal_jax).
    The port's counts equal JAX's at 64² here and these constants on the
    card."""
    model, v = _jax_model("unet", "serve")
    x, t = jax.ShapeDtypeStruct((1, 256, 256, 1), jnp.float32), jnp.zeros((1,), jnp.int32)
    assert jflops.count_flops(lambda w, a: model.apply(w, a, a, t), v, x) == chip_smoke.FLOPS_UNET_FWD
    assert chip_smoke.FLOPS_DDIM50 == 50 * chip_smoke.FLOPS_UNET_FWD
    assert _jax_step("diffusion", model, v["params"], 256) == chip_smoke.FLOPS_DIFFUSION_STEP
    nmodel, nv = _jax_model("nafnet", "serve")
    assert jflops.count_flops(nmodel.apply, nv, x) == chip_smoke.FLOPS_NAFNET_FWD
    assert _jax_step("nafnet", nmodel, nv["params"], 256) == chip_smoke.FLOPS_NAFNET_STEP


def test_transposed_convolution_counted_at_output_resolution():
    """One ConvTranspose2d(k 4, s 2, p 1): 2·numel(out)·Cin·16 forward (4×
    torch's own FlopCounterMode, which counts it at the input's); its input
    gradient at the input's resolution, its weight gradient as the forward."""
    up = torch.nn.ConvTranspose2d(8, 4, 4, stride=2, padding=1)
    x = torch.zeros(2, 8, 5, 5, requires_grad=True)
    fwd = 2 * (2 * 4 * 10 * 10) * 8 * 16
    with torch.no_grad():
        assert flops.count_flops(up, x) == fwd
    dx = 2 * (2 * 8 * 5 * 5) * 4 * 16
    assert flops.count_flops(lambda: up(x).sum().backward()) == fwd + dx + fwd
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as stock, torch.no_grad():
        up(x)
    assert stock.get_total_flops() * 4 == fwd


def test_strided_convolution_backward_counts_dilated_input_gradient():
    conv = torch.nn.Conv2d(4, 6, 3, stride=2, padding=1, groups=2)
    x = torch.zeros(1, 4, 8, 8, requires_grad=True)
    fwd = 2 * (1 * 6 * 4 * 4) * 2 * 9
    dx = 2 * (1 * 4 * 8 * 8) * 3 * 9
    assert flops.count_flops(lambda: conv(x).sum().backward()) == fwd + dx + fwd


def test_matrix_products_and_padding():
    a, b = torch.zeros(5, 7), torch.zeros(7, 3)
    assert flops.count_flops(torch.matmul, a, b) == 2 * 5 * 7 * 3
    assert flops.count_flops(torch.matmul, a, b, lane_pad=(8, 128)) == 2 * 8 * 128 * 128
    assert flops.count_flops(torch.bmm, torch.zeros(2, 5, 7), torch.zeros(2, 7, 3)) == 2 * 2 * 5 * 7 * 3
    assert flops.count_flops(torch.nn.functional.linear, a, torch.zeros(3, 7), torch.zeros(3)) == 2 * 5 * 7 * 3
    assert flops.count_flops(torch.softmax, a, -1) == 0


def test_device_peak_tflops_raises_off_the_card_of_record():
    with pytest.raises(ValueError, match="cpu"):
        flops.device_peak_tflops("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cpu"):
            flops.device_peak_tflops()
    assert flops.PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}


def test_mfu():
    assert flops.mfu(989e12, 2.0, 989.0) == 0.5
    assert flops.mfu(1e12, 0.5, 4.0) == jflops.mfu(1e12, 0.5, 4.0)
    assert np.isclose(flops.mfu(chip_smoke.FLOPS_DIFFUSION_STEP, 0.1, 989.0), 665.342558208e9 / 0.1 / 989e12)
