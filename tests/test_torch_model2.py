"""The ``MODEL2_NAFNET`` variant (multiscale intro, additive skips; width 24,
stages at C 24, 48, 96, 192 and 384) in the port against the JAX package:
its parameter count and keys, the module's forward and ``nafnet_apply_fused``
(JAX's fused forward runs its Pallas FFN in interpret mode from C 128 up; the
port fuses at every C, through the FFN kernel's plain version on the CPU).
The card holds the port's ln2d and naf_ffn kernels against their plain
versions at every stage shape (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.ops.naf_fast import nafnet_apply_fused as jax_nafnet_apply_fused
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.ops.naf_fast import nafnet_apply_fused
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from tests.torch_port_util import image, jax_apply, jax_init, nchw, nhwc, perturb, port


@pytest.fixture(scope="module")
def model2():
    """MODEL2_NAFNET with perturbed JAX weights (every bias, norm, beta and
    gamma non-trivial), a 32x48 input (padded to 32x48: a multiple of 16),
    and JAX's module output."""
    rng = np.random.default_rng(21)
    x = image(rng, 1, 32, 48, 1)
    jmodel = jm.EnhancedNAFNet(jcfg.MODEL2_NAFNET)
    variables = perturb(jax_init(jmodel, jnp.asarray(x)), rng)
    return x, variables, jax_apply(jmodel, variables, jnp.asarray(x))


def test_model2_config_and_parameters(model2):
    _, variables, _ = model2
    assert tcfg.MODEL2_NAFNET == tcfg.NAFNetConfig(**jcfg.MODEL2_NAFNET.asdict())
    model = EnhancedNAFNet(tcfg.MODEL2_NAFNET)
    assert sum(p.numel() for p in model.parameters()) == 10_803_361  # tests/test_models.py:73
    sd = model.state_dict()
    assert sd.keys() == state_dict_from_jax(variables).keys()
    assert "multiscale_conv.2.weight" in sd and "fusion.weight" in sd
    assert not any(k.startswith("skip_convs") for k in sd)


def test_model2_module_matches_jax(model2):
    """fp32 convolutions and norms summed in another order through ~25
    NAFBlocks: 1e-4 of max|out| (the card-vs-CPU NAFNet bound of
    chip_smoke.py)."""
    x, variables, want = model2
    model = port(EnhancedNAFNet(tcfg.MODEL2_NAFNET), variables)
    with torch.no_grad():
        got = nhwc(model(nchw(x)))
    assert got.shape == want.shape == (1, 32, 48, 1)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_model2_nafnet_apply_fused_matches_jax(model2):
    """The fused forwards of both packages, and the module: the fused norms
    take a centred variance where the module's take E[x²] − u² (both fp32),
    the same 1e-4 of max|out|."""
    x, variables, want_module = model2
    cfg = jcfg.MODEL2_NAFNET
    want = np.asarray(jax.jit(lambda p, a: jax_nafnet_apply_fused(p, cfg, a))(
        variables["params"], jnp.asarray(x)))
    model = port(EnhancedNAFNet(tcfg.MODEL2_NAFNET), variables)
    with torch.no_grad():
        got = nhwc(nafnet_apply_fused(model, nchw(x)))
    bound = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - want_module).max() <= bound


def test_engine_reads_a_width_checkpoint_as_the_plain_topology(tmp_path):
    """``_nafnet_cfg_from_meta`` as the JAX engine has it: a checkpoint's
    ``width`` and block counts give a plain-topology config, whatever the
    engine's ``nafnet_cfg`` holds."""
    meta = {"width": 24, "middle_blk_num": 8, "enc_blk_nums": [1, 2, 2, 4], "dec_blk_nums": [1, 1, 2, 2]}
    cfg = InferenceEngine._nafnet_cfg_from_meta(meta, tcfg.MODEL2_NAFNET)
    assert cfg.width == 24 and not cfg.multiscale_intro and not cfg.additive_skips
    assert InferenceEngine._nafnet_cfg_from_meta({}, tcfg.MODEL2_NAFNET) is tcfg.MODEL2_NAFNET
    # the engine serves the variant given as its nafnet_cfg
    eng = InferenceEngine(EngineConfig(img_size=32, nafnet_cfg=tcfg.MODEL2_NAFNET, ckpt_dir=str(tmp_path),
                                       diffusion_cfg=tcfg.DiffusionUNetConfig(
                                           model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                                           attention_resolutions=(1,), time_emb_dim=16),
                                       expert_cfg=tcfg.ExpertConfig(base_channels=8),
                                       router_cfg=tcfg.RouterConfig(base_c=8),
                                       fusion_cfg=tcfg.FusionConfig(base_c=16), warmup=False, device="cpu"))
    try:
        y = eng.fns["nafnet"](image(np.random.default_rng(0), 1, 32, 32, 1))
        assert y.shape == (1, 32, 32, 1) and np.isfinite(y).all()
    finally:
        eng.close()
