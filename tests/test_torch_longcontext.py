"""The 1024² operating point and ``EngineConfig.use_flash_attention`` in the
port, against tests/test_longcontext.py's contract and the JAX engine.

At 1024² the UNet's attention runs over N = 128² = 16384 tokens. The port's
exact paths (``mha_reference``, and ``flash_attention_plain``, which the flash
path takes on the CPU) work through blocks of query rows, so neither builds
the 16384² logits of a head. The JAX engine at 1024² costs over a minute on
the CPU (tests/test_longcontext.py), so the port is held against it at 256²
(N 1024, where JAX's ``use_flash_attention=True`` runs the Pallas kernel in
interpret mode; 64² where both sides run the exact reference) and runs the
1024² contract on its own.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.ops import flash_attention as fa
from midd_tpu_torch.ops.attention import mha, mha_reference
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from tests.torch_port_util import image, jax_init, perturb


def _tiny_1024(cfg):
    """tests/test_longcontext.py's TINY_1024: the serving topology (4
    resolutions, attention at index 3) at tiny width."""
    return dict(
        img_size=1024,
        diffusion_steps=1,
        hybrid_diffusion_steps=1,
        nafnet_cfg=cfg.NAFNetConfig(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)),
        diffusion_cfg=cfg.DiffusionUNetConfig(model_channels=8, channel_mult=(1, 2, 3, 4), num_res_blocks=1,
                                              attention_resolutions=(3,), time_emb_dim=16),
        use_flash_attention=True,
        expert_cfg=cfg.ExpertConfig(base_channels=8),
        router_cfg=cfg.RouterConfig(base_c=8),
        fusion_cfg=cfg.FusionConfig(base_c=16),
        schedule_cfg=cfg.ScheduleConfig(noise_steps=6),
        ckpt_dir="/nonexistent",
        warmup=False,
    )


def _full_attention(q, k, v):
    """The unblocked formula, (B, N, H, D)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def test_exact_attention_blocks_match_the_full_matrix():
    """N 2500: two full row blocks and a ragged one."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2500, 2, 16, generator=g) for _ in range(3))
    want = _full_attention(q, k, v)
    assert torch.allclose(mha_reference(q, k, v), want, atol=1e-6, rtol=0)
    assert torch.allclose(mha(q, k, v, use_flash=False), want, atol=1e-6, rtol=0)
    bh = lambda t: t.permute(0, 2, 1, 3).reshape(2, 2500, 16)  # noqa: E731
    o, lse = fa.flash_attention_plain(bh(q), bh(k), bh(v))
    s = torch.matmul(bh(q), bh(k).transpose(-1, -2)) / 4.0
    assert torch.allclose(o, bh(want), atol=1e-6, rtol=0)
    assert torch.allclose(lse, torch.logsumexp(s, dim=-1), atol=1e-6, rtol=0)
    # use_flash=True on the CPU is the flash kernel's plain version
    assert torch.equal(mha(q, k, v, use_flash=True), o.view(1, 2, 2500, 16).permute(0, 2, 1, 3))


@pytest.fixture(scope="module")
def ckpt_256(tmp_path_factory):
    """A diffusion.pth of the TINY_1024 UNet from perturbed JAX weights."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    rng = np.random.default_rng(7)
    x, t = jnp.zeros((1, 256, 256, 1)), jnp.zeros((1,), jnp.int32)
    unet = jm.UNetDiffusion(_tiny_1024(jcfg)["diffusion_cfg"])
    sd = state_dict_from_jax(perturb(jax_init(unet, x, x, t, seed=3), rng))
    torch.save({"model_state_dict": sd}, os.path.join(d, "diffusion.pth"))
    return d


@pytest.mark.parametrize("use_flash,size", [(True, 256), (False, 64), (None, 64)])
def test_use_flash_attention_matches_jax(ckpt_256, use_flash, size):
    """Exact fp32 evals: flash at 256² (N 1024; JAX: the Pallas kernel in
    interpret mode, the port: the flash kernel's plain version), exact
    (both: the reference) or auto (the CPU resolves to exact on both
    sides). 2e-4, the torch-oracle suite's bound (tests/test_parity_torch.py)."""
    kw = {**_tiny_1024(tcfg), "img_size": size, "ckpt_dir": ckpt_256, "use_flash_attention": use_flash,
          "diffusion_eval_bf16": False, "hybrid_rollout_bf16": False}
    teng = InferenceEngine(EngineConfig(**kw, device="cpu"))
    jeng = JEngine(JEngineConfig(**{**kw, **_tiny_1024(jcfg), "img_size": size, "ckpt_dir": ckpt_256,
                                    "use_flash_attention": use_flash}, persistent_cache=False))
    assert teng.serving_mode()["flash_attention"] == jeng.serving_mode()["flash_attention"] == bool(use_flash)
    x = image(np.random.default_rng(1), 1, size, size, 1)
    np.testing.assert_allclose(teng.fns["diffusion"](x), np.asarray(jeng.fns["diffusion"](jnp.asarray(x))),
                               atol=2e-4)
    teng.close()


def test_engine_1024_end_to_end():
    """One 1024² request through all four paths (tests/test_longcontext.py):
    shape, finite, clamped. The exact attention path serves the diffusion
    path too: it agrees with flash up to the bf16 evals' rounding (2^-8 of
    eps per rounding, through the UNet's layers; eps enters the one t = 0
    step with a coefficient of 0.01; measured 3.1e-4)."""
    eng = InferenceEngine(EngineConfig(**_tiny_1024(tcfg), device="cpu"))
    x = np.random.default_rng(0).random((1, 1024, 1024, 1), dtype=np.float32)
    outs = {}
    for name in MODEL_NAMES:
        outs[name] = eng.fns[name](x)
        assert outs[name].shape == (1, 1024, 1024, 1), name
        assert np.isfinite(outs[name]).all(), name
        assert outs[name].min() >= 0.0 and outs[name].max() <= 1.0, name
    eng.close()
    exact = InferenceEngine(EngineConfig(**{**_tiny_1024(tcfg), "use_flash_attention": False}, device="cpu"))
    assert exact.serving_mode()["flash_attention"] is False
    np.testing.assert_allclose(exact.fns["diffusion"](x), outs["diffusion"], atol=1e-3)
    exact.close()


def test_auto_buckets_at_1024():
    eng = InferenceEngine(EngineConfig(**_tiny_1024(tcfg), batching=True, device="cpu"))
    try:
        assert tuple(eng.batcher.buckets) == (1,)
    finally:
        eng.close()
