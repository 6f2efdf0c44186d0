"""The port's models against the JAX package's at small widths, fp32 on the
CPU, with JAX-initialised (perturbed) weights carried over through
``state_dict_from_jax``; and the serving presets' parameter counts."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import FusionModule, NoiseAnalyzer
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from tests.torch_port_util import image, jax_apply, jax_init, nchw, nhwc, perturb, port, rand

ATOL = 2e-4

TINY_UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1,), time_emb_dim=32)


@pytest.mark.parametrize("fuse_updown", [True, False])
def test_unet_diffusion_matches_jax_default(rng, fuse_updown):
    """Against the JAX default forward (s2d stage 0 and fused up/down on)."""
    x = rand(rng, 1, 16, 16, 1) * 0.3
    cond = rand(rng, 1, 16, 16, 1) * 0.3
    t = np.array([7], np.int32)
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**TINY_UNET))
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    variables = perturb(jax_init(jmodel, *args), rng)
    want = jax_apply(jmodel, variables, *args)
    ours = port(UNetDiffusion(tcfg.DiffusionUNetConfig(**TINY_UNET), fuse_updown=fuse_updown), variables)
    with torch.no_grad():
        got = nhwc(ours(nchw(x), nchw(cond), torch.from_numpy(t.astype(np.int64))))
    np.testing.assert_allclose(got, want, atol=5e-4)  # test_parity_torch's UNet tolerance


def test_unet_three_levels_odd_ping_pong(rng):
    """Three levels at a size whose decoder ping-pong needs non-2x resizes."""
    cfg = dict(model_channels=8, channel_mult=(1, 2, 2), num_res_blocks=1,
               attention_resolutions=(2,), time_emb_dim=16)
    x, cond = rand(rng, 1, 20, 12, 1) * 0.3, rand(rng, 1, 20, 12, 1) * 0.3
    t = np.array([3], np.int32)
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**cfg))
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    variables = perturb(jax_init(jmodel, *args), rng)
    want = jax_apply(jmodel, variables, *args)
    ours = port(UNetDiffusion(tcfg.DiffusionUNetConfig(**cfg)), variables)
    with torch.no_grad():
        got = nhwc(ours(nchw(x), nchw(cond), torch.from_numpy(t.astype(np.int64))))
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_cddpm_unet_param_count():
    model = UNetDiffusion(tcfg.CDDPM_UNET)
    assert sum(p.numel() for p in model.parameters()) == 12_526_273  # cddpm/cddpmModels.py:176


def test_nafnet_odd_size(rng):
    kw = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 2), dec_blk_nums=(1, 1))
    x = image(rng, 1, 19, 13, 1)
    jmodel = jm.EnhancedNAFNet(jcfg.NAFNetConfig(**kw))
    variables = perturb(jax_init(jmodel, jnp.asarray(x)), rng)
    want = jax_apply(jmodel, variables, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(port(EnhancedNAFNet(tcfg.NAFNetConfig(**kw)), variables)(nchw(x)))
    assert got.shape == (1, 19, 13, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_expert_random_running_stats(rng):
    x = image(rng, 1, 16, 16, 1)
    jmodel = jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=8))
    variables = perturb(jax_init(jmodel, jnp.asarray(x)), rng)
    assert "batch_stats" in variables
    want = jax_apply(jmodel, variables, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(port(ExpertDenoiser(tcfg.ExpertConfig(base_channels=8)), variables)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_noise_analyzer_odd_size(rng):
    x = image(rng, 1, 21, 15, 1)  # odd size -> the resize shape-fixes
    jmodel = jm.NoiseAnalyzer(jcfg.RouterConfig(base_c=8))
    variables = perturb(jax_init(jmodel, jnp.asarray(x)), rng)
    want = jax_apply(jmodel, variables, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(port(NoiseAnalyzer(tcfg.RouterConfig(base_c=8)), variables)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("residual,sees_expert", [(False, False), (True, False), (True, True)])
def test_fusion_heads(rng, residual, sees_expert):
    ins = [image(rng, 1, 12, 12, 1) for _ in range(3 + int(sees_expert))]
    kw = dict(base_c=16, residual=residual, sees_expert=sees_expert)
    jmodel = jm.FusionModule(jcfg.FusionConfig(**kw))
    jins = [jnp.asarray(a) for a in ins]
    variables = perturb(jax_init(jmodel, *jins), rng)
    want = jax_apply(jmodel, variables, *jins)
    with torch.no_grad():
        got = nhwc(port(FusionModule(tcfg.FusionConfig(**kw)), variables)(*map(nchw, ins)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("build,count", [
    (lambda: UNetDiffusion(tcfg.SERVE_DIFFUSION), 12_823_489),
    (lambda: EnhancedNAFNet(tcfg.SERVE_NAFNET), 20_991_105),
    (lambda: ExpertDenoiser(tcfg.SERVE_EXPERT), 7_629_185),
    (lambda: NoiseAnalyzer(tcfg.RouterConfig()), 374_497),
    (lambda: FusionModule(tcfg.FusionConfig()), 11_905),
])
def test_serving_preset_param_counts(build, count):
    """The JAX package's counts (tests/test_models.py); built on the meta
    device, so nothing is allocated."""
    with torch.device("meta"):
        model = build()
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("name", ["SERVE_DIFFUSION", "SERVE_NAFNET", "SERVE_EXPERT", "SERVE_SCHEDULE",
                                  "SERVE_HYBRID", "TPU_HYBRID", "SERVE_IMG_SIZE",
                                  "SERVE_DIFFUSION_STEPS"])
def test_config_copy_matches_jax(name):
    """The port's own copy of a preset equals the JAX package's; a field the
    copy leaves out (a variant the port does not run) is off in JAX's."""
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    if not dataclasses.is_dataclass(ours):
        assert ours == theirs
        return
    ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)

    def check(a, b):
        for key, value in b.items():
            if key not in a:
                assert not value, key
            elif isinstance(value, dict):
                check(a[key], value)
            else:
                assert a[key] == value, key

    check(ours, theirs)
