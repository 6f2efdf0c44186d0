"""The port's inference and evaluate entry points against the JAX package's
(``midd_tpu/inference.py``, ``midd_tpu/evaluate.py``) on the same ``.pth``
files: the 4-flip TTA to 1e-3, ``evaluate`` over a seeded 4-pair dataset at
32² to 0.01 dB PSNR and 1e-4 SSIM (reference-exact fp32 on both sides);
``denoise_image`` answers at the original size, ``save_comparison`` is
never fatal, and both CLIs run on the CPU when asked.
"""

import builtins
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from midd_tpu import config as jcfg
from midd_tpu import evaluate as jevaluate
from midd_tpu import inference as jinference
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu.train.data import PairedXRayDataset as JDataset
from midd_tpu_torch import config as tcfg
from midd_tpu_torch import evaluate as tevaluate
from midd_tpu_torch import inference as tinference
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train.data import PairedXRayDataset
from tests.test_torch_serve import _tiny, _write_checkpoints
from tests.torch_port_util import image


def _arch(cfg):
    """The tiny architectures, without the fields evaluate sets itself."""
    return {k: v for k, v in _tiny(cfg).items() if k not in ("img_size", "warmup")}


def _png(path, arr):
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8), mode="L").save(path)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    _write_checkpoints(d, np.random.default_rng(13))
    return d


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """4 seeded clean/noisy 32² pairs on disk."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(5)
    for sub in ("clean", "noisy"):
        os.makedirs(root / sub)
    for i in range(4):
        yy, xx = np.mgrid[0:32, 0:32] / 32
        clean = 0.3 + 0.4 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.4 - 0.05 * i) ** 2) / 0.08)
        _png(root / "clean" / f"img{i}.png", clean)
        _png(root / "noisy" / f"img{i}.png", clean + 0.08 * rng.standard_normal(clean.shape))
    return str(root / "clean"), str(root / "noisy")


def test_tta_4flip_matches_jax(ckpt_dir):
    exact = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
    teng = InferenceEngine(EngineConfig(**_tiny(tcfg), **exact, ckpt_dir=ckpt_dir, device="cpu"))
    jeng = JEngine(JEngineConfig(**_tiny(jcfg), **exact, ckpt_dir=ckpt_dir, persistent_cache=False))
    try:
        x = image(np.random.default_rng(2), 1, 32, 32, 1)
        got = tinference.tta_4flip(teng.fns["nafnet"])(x)
        want = np.asarray(jax.jit(jinference.tta_4flip(jeng.fns["nafnet"]))(jnp.asarray(x)))
        assert got.shape == (1, 32, 32, 1)
        np.testing.assert_allclose(got, want, atol=1e-3)
        # not the plain forward: the flips change the answer
        assert np.abs(got - teng.fns["nafnet"](x)).max() > 1e-6
    finally:
        teng.close()


def test_evaluate_matches_jax(ckpt_dir, pairs):
    clean, noisy = pairs
    got = tevaluate.evaluate("hybrid", PairedXRayDataset(clean, [noisy], img_size=32, is_train=False),
                             ckpt_dir=ckpt_dir, img_size=32, engine_kwargs=_arch(tcfg), device="cpu")
    want = jevaluate.evaluate("hybrid", JDataset(clean, [noisy], img_size=32, is_train=False),
                              ckpt_dir=ckpt_dir, img_size=32,
                              engine_kwargs={**_arch(jcfg), "persistent_cache": False})
    assert got["n"] == want["n"] == 4
    assert abs(got["psnr"] - want["psnr"]) <= 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4, (got, want)
    assert np.isfinite(got["p50_latency_s"])


def test_denoise_image_answers_at_the_original_size(tmp_path):
    path = str(tmp_path / "x.png")
    _png(path, image(np.random.default_rng(1), 30, 40))
    img, dt = tinference.denoise_image("expert", path, ckpt_dir="/nonexistent", img_size=32, tta=True,
                                       device="cpu")
    assert img.size == (40, 30) and img.mode == "L" and dt > 0


def test_save_comparison_is_never_fatal(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "x.png")
    _png(path, image(np.random.default_rng(0), 24, 24))
    out = str(tmp_path / "cmp.png")
    den = Image.open(path)
    assert tinference.save_comparison(path, den, out) is True and os.path.getsize(out) > 0

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert tinference.save_comparison(path, den, str(tmp_path / "none.png")) is False
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "none.png")


def test_clis_run_on_the_cpu_when_asked(pairs, tmp_path, capsys):
    clean, noisy = pairs
    src = os.path.join(noisy, "img0.png")
    out = str(tmp_path / "out.png")
    tinference.main(["--model", "nafnet", "--image", src, "--out", out, "--img-size", "32",
                     "--tta", "--ckpt-dir", "/nonexistent", "--device", "cpu"])
    assert Image.open(out).size == (32, 32)
    result = tevaluate.main(["--model", "expert", "--clear-dir", clean, "--noisy-dirs", noisy,
                             "--img-size", "32", "--ckpt-dir", "/nonexistent", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result and result["n"] == 4 and np.isfinite(result["psnr"])
