"""The expert branch of a ``sees_expert`` hybrid, port against the JAX engine
(mirrors tests/test_checkpoint_serving.py::test_hybrid_expert_branch_prefers_ftl2_tree
on ``.pth`` files made with ``state_dict_from_jax``).

With ``<ckpt_dir>/expert_ftl2.pth`` present, the hybrid's fourth input comes
from that tree and ``serving_mode()["hybrid_expert_tree"]`` says
``"expert_ftl2"``; without it the branch shares the standalone expert
(``"shared"``). The standalone expert path is the same in both directories,
the hybrid's differs, and each port output agrees with the JAX engine's on
the same files to 1e-3 (exact fp32, the tolerance of
``test_port_engine_matches_jax_engine_on_pth_checkpoints``).
"""

import os
import shutil

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
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from tests.test_torch_serve import _tiny, _write_checkpoints
from tests.torch_port_util import image, jax_init, perturb, write_router_fusion_hybrid

EXACT = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False)


def _expert_fed(cfg):
    return {**_tiny(cfg), "fusion_cfg": cfg.FusionConfig(base_c=16, sees_expert=True)}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """``two``: every backend's .pth, expert_ftl2.pth and a router+fusion
    sees_expert hybrid; ``one``: the same without expert_ftl2.pth. Each as
    the port reads it and as the JAX engine reads it (the hybrid as an orbax
    directory there)."""
    rng = np.random.default_rng(23)
    out = {key: str(tmp_path_factory.mktemp(key)) for key in ("two", "one", "jax_two", "jax_one")}
    _write_checkpoints(out["two"], rng)
    write_router_fusion_hybrid(out["two"], out["jax_two"], rng, jcfg.RouterConfig(base_c=8),
                               jcfg.FusionConfig(base_c=16, sees_expert=True))
    ftl2 = jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=8))
    torch.save({"model_state_dict": state_dict_from_jax(
        perturb(jax_init(ftl2, jnp.zeros((1, 32, 32, 1)), seed=9), rng))},
        os.path.join(out["two"], "expert_ftl2.pth"))
    for name in ("diffusion", "nafnet", "expert", "expert_ftl2"):
        shutil.copy(os.path.join(out["two"], f"{name}.pth"), out["jax_two"])
    shutil.copytree(os.path.join(out["jax_two"], "hybrid"), os.path.join(out["jax_one"], "hybrid"))
    for name in ("diffusion", "nafnet", "expert", "hybrid"):
        shutil.copy(os.path.join(out["two"], f"{name}.pth"), out["one"])
        if name != "hybrid":
            shutil.copy(os.path.join(out["two"], f"{name}.pth"), out["jax_one"])
    return out


def test_hybrid_expert_branch_prefers_ftl2_tree(dirs):
    x = image(np.random.default_rng(4), 1, 32, 32, 1)
    outs = {}
    for key, tree in (("two", "expert_ftl2"), ("one", "shared")):
        teng = InferenceEngine(EngineConfig(**_expert_fed(tcfg), **EXACT, ckpt_dir=dirs[key], device="cpu"))
        jeng = JEngine(JEngineConfig(**_expert_fed(jcfg), **EXACT, ckpt_dir=dirs["jax_" + key],
                                     persistent_cache=False))
        assert teng.serving_mode()["hybrid_expert_tree"] == jeng.serving_mode()["hybrid_expert_tree"] == tree
        outs[key] = {name: teng.fns[name](x) for name in MODEL_NAMES}
        for name in MODEL_NAMES:
            want = np.asarray(jeng.fns[name](jnp.asarray(x)))
            np.testing.assert_allclose(outs[key][name], want, atol=1e-3, err_msg=f"{key}/{name}")
        teng.close()
    # the standalone expert serves expert.pth in both directories
    np.testing.assert_array_equal(outs["two"]["expert"], outs["one"]["expert"])
    # the hybrid's fourth input is another tree
    assert np.abs(outs["two"]["hybrid"] - outs["one"]["hybrid"]).max() > 1e-3


def test_expert_branch_tree_loads_batchnorm_buffers_strictly(dirs, tmp_path):
    """expert_ftl2.pth is loaded with strict=True: a file without its
    BatchNorm running statistics is refused."""
    for name in ("diffusion", "nafnet", "expert", "hybrid"):
        shutil.copy(os.path.join(dirs["one"], f"{name}.pth"), tmp_path)
    ckpt = torch.load(os.path.join(dirs["two"], "expert_ftl2.pth"), weights_only=False)
    sd = {k: v for k, v in ckpt["model_state_dict"].items() if "running_" not in k}
    torch.save({"model_state_dict": sd}, os.path.join(tmp_path, "expert_ftl2.pth"))
    with pytest.raises(RuntimeError, match="running_mean"):
        InferenceEngine(EngineConfig(**_expert_fed(tcfg), ckpt_dir=str(tmp_path), device="cpu"))


def test_fusion_without_expert_ignores_the_ftl2_tree(dirs, tmp_path):
    """A fusion that takes no expert never reads expert_ftl2; the mode says
    "shared", as the JAX engine says."""
    _write_checkpoints(str(tmp_path), np.random.default_rng(2))
    shutil.copy(os.path.join(dirs["two"], "expert_ftl2.pth"), tmp_path)
    eng = InferenceEngine(EngineConfig(**_tiny(tcfg), **EXACT, ckpt_dir=str(tmp_path), device="cpu"))
    assert eng.serving_mode()["hybrid_expert_tree"] == "shared"
    assert "expert_ftl2" not in eng.meta
    eng.close()
