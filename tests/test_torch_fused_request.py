"""Fused requests of the port (mirrors tests/test_fused_request.py): all four
paths of a request in one function. On a hybrid checkpoint that holds only
router and fusion weights the hybrid rides the standalone backends, so the
fused function computes the NAFNet forward, and with matching rollout
settings the rollout, once. Fused outputs equal the per-path ones (1e-6) in
every sharing regime, and ``shares`` and ``hybrid_eps_reuse`` are the JAX
engine's for the same files and settings.
"""

import os
import shutil

import numpy as np
import pytest

from midd_tpu import config as jcfg
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from tests.test_torch_serve import _small, _write_checkpoints
from tests.torch_port_util import image, write_router_fusion_hybrid

WAIT = 30.0


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Backend .pth files and a router+fusion-only hybrid, as the port reads
    them and as the JAX engine reads them."""
    rng = np.random.default_rng(31)
    dirs = {key: str(tmp_path_factory.mktemp(key)) for key in ("port", "jax")}
    _write_checkpoints(dirs["port"], rng)
    write_router_fusion_hybrid(dirs["port"], dirs["jax"], rng, jcfg.RouterConfig(base_c=8),
                               jcfg.FusionConfig(base_c=16))
    for name in ("diffusion", "nafnet", "expert"):
        shutil.copy(os.path.join(dirs["port"], f"{name}.pth"), dirs["jax"])
    return dirs


def _engines(ckpt, **kw):
    """The port's engine and the JAX engine's resolved sharing decisions."""
    port_dir = ckpt["port"] if ckpt else "/nonexistent"
    jax_dir = ckpt["jax"] if ckpt else "/nonexistent"
    eng = InferenceEngine(EngineConfig(**_small(tcfg), ckpt_dir=port_dir, device="cpu", **kw))
    jeng = JEngine(JEngineConfig(**_small(jcfg), ckpt_dir=jax_dir, persistent_cache=False,
                                 **kw))
    if jeng.batcher is not None:
        jeng.batcher.stop()
    assert eng.hybrid_eps_reuse == jeng.hybrid_eps_reuse
    assert eng.diffusion_eps_reuse == jeng.diffusion_eps_reuse
    if kw.get("fused_request"):
        assert eng.shares == jeng.shares
    return eng


def _assert_fused_matches(engine):
    x = np.concatenate([image(np.random.default_rng(7), 1, 16, 16, 1) for _ in range(2)])
    fused = engine.fused(x)
    for name in MODEL_NAMES:
        np.testing.assert_allclose(fused[name], engine.fns[name](x), atol=1e-6, err_msg=name)


def test_fused_shared_backends_full_sharing(ckpt):
    """Same steps and eps settings: the NAFNet forward and the rollout are
    computed once, and the outputs are the per-path ones."""
    eng = _engines(ckpt, fused_request=True, turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1)
    try:
        assert eng.shares == {"backends": True, "rollout": True}
        _assert_fused_matches(eng)
    finally:
        eng.close()


def test_hybrid_turbo_auto_matches_shared_rollout(ckpt):
    """Auto hybrid eps: where the fused request shares the standalone rollout
    (an int k <= 2), the hybrid takes k; the per-path engine and the demo
    engine keep k = 2."""
    eng = _engines(ckpt, fused_request=True)
    demo = _engines(None)
    perpath = _engines(ckpt)
    try:
        assert eng.hybrid_eps_reuse == 1
        assert eng.shares == {"backends": True, "rollout": True}
        _assert_fused_matches(eng)
        assert demo.hybrid_eps_reuse == 2
        assert perpath.fused is None and perpath.hybrid_eps_reuse == 2
    finally:
        for e in (eng, demo, perpath):
            e.close()


@pytest.mark.parametrize("kw,shares", [
    # the rollouts differ (exact vs k = 2): only the NAFNet forward is shared
    (dict(turbo_eps_reuse=1, hybrid_turbo_eps_reuse=2), {"backends": True, "rollout": False}),
    # auto never inherits an ungated standalone k > 2
    (dict(turbo_eps_reuse=4), {"backends": True, "rollout": False}),
])
def test_fused_partial_sharing(ckpt, kw, shares):
    eng = _engines(ckpt, fused_request=True, **kw)
    try:
        assert eng.shares == shares
        assert eng.hybrid_eps_reuse == 2
        _assert_fused_matches(eng)
    finally:
        eng.close()


def test_fused_rollout_not_shared_across_eval_precisions(ckpt):
    """The port shares the rollout only where both paths evaluate the UNet in
    one precision (the JAX engine shares it here too, and its fused hybrid
    then differs from its per-path one)."""
    eng = InferenceEngine(EngineConfig(**_small(tcfg), ckpt_dir=ckpt["port"], device="cpu",
                                       fused_request=True, diffusion_eval_bf16=False))
    try:
        assert eng.hybrid_eps_reuse == 1
        assert eng.shares == {"backends": True, "rollout": False}
        _assert_fused_matches(eng)
    finally:
        eng.close()


def test_fused_forced_on_demo_weights():
    """Demo weights: the hybrid has its own backends, nothing is shared, and
    the fused outputs are still the per-path ones."""
    eng = _engines(None, fused_request=True)
    try:
        assert eng.shares["backends"] is False
        _assert_fused_matches(eng)
    finally:
        eng.close()


def test_fused_off_by_default():
    eng = InferenceEngine(EngineConfig(**_small(tcfg), ckpt_dir="/nonexistent", device="cpu"))
    try:
        assert eng.fused is None and eng.serving_mode()["fused_request"] is False
    finally:
        eng.close()


def test_fused_through_batcher(ckpt):
    eng = InferenceEngine(EngineConfig(**_small(tcfg), ckpt_dir=ckpt["port"], device="cpu",
                                       batching=True, fused_request=True))
    try:
        assert eng.batcher.fused_fn is eng.fused
        x = image(np.random.default_rng(1), 1, 16, 16, 1)
        outs = eng.batcher.process(x, timeout=WAIT)
        for name in MODEL_NAMES:
            np.testing.assert_allclose(outs[name], eng.fns[name](x), atol=1e-6, err_msg=name)
        assert eng.fused_failures == 0
    finally:
        eng.close()


@pytest.mark.parametrize("batching", [False, True])
def test_fused_failure_falls_back_per_path_and_is_counted(batching):
    """A fused call that raises is logged, counted in ``fused_failures`` (and
    /health) and answered by the per-path functions."""
    eng = InferenceEngine(EngineConfig(**_small(tcfg), ckpt_dir="/nonexistent", device="cpu",
                                       fused_request=True, batching=batching))

    def boom(x):
        raise RuntimeError("injected")

    try:
        eng._fused_path = boom
        out = eng.process_all(image(np.random.default_rng(0), 1, 16, 16, 1), (16, 16))
        assert all(out[n] is not None for n in MODEL_NAMES)
        assert eng.fused_failures == 1 and eng.health()["fused_failures"] == 1
    finally:
        eng.close()
