"""The port's native data path (``midd_tpu_torch/native.py``, built from
its own copy of the C++ source) against the JAX package's bridge
(``midd_tpu/native.py``) and PIL, on the CPU; ``load_image``'s
``use_native`` and ``MIDD_TPU_NATIVE``; ``visualize_pairs`` and its call
in the recipes' CLI."""

import os

import numpy as np
import pytest
from PIL import Image

from midd_tpu import native as jnative
from midd_tpu_torch import native
from midd_tpu_torch.train import data as tdata
from midd_tpu_torch.train import recipes as trecipes

# PIL rounds its fixed-point bicubic passes differently from the kernel's
# double-precision ones: within 2 of 255 (the JAX bridge's documented bound)
PIL_LSB = 2

SHAPES = [((300, 200), (64, 80)), ((40, 50), (97, 61)), ((256, 256), (256, 256)), ((17, 333), (128, 32))]


def _u8(rng, shape):
    return (rng.random(shape) * 255).astype(np.uint8)


def test_the_library_builds_into_the_ports_build_directory():
    assert native.available(), native.error()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE.read_bytes() != b"" and native.SOURCE.parent.name == "csrc"


@pytest.mark.parametrize("src,size", SHAPES)
def test_u8_resize_bit_equal_to_jax_bridge_and_near_pil(src, size):
    img = _u8(np.random.default_rng(0), src)
    got = native.resize_bicubic_u8(img, size)
    np.testing.assert_array_equal(got, jnative.resize_bicubic_u8(img, size))  # bit for bit
    pil = np.asarray(Image.fromarray(img).resize(size[::-1], Image.BICUBIC))
    assert np.abs(got.astype(int) - pil).max() <= PIL_LSB


@pytest.mark.parametrize("src,size", SHAPES)
def test_f32_resize_bit_equal_to_jax_bridge(src, size):
    img = np.random.default_rng(1).random(src).astype(np.float32)
    np.testing.assert_array_equal(native.resize_bicubic_f32(img, size), jnative.resize_bicubic_f32(img, size))


@pytest.mark.parametrize("flips", [(False, False), (True, False), (False, True), (True, True)])
def test_augment_pair_bit_equal_to_jax_bridge(flips):
    rng = np.random.default_rng(2)
    clean, noisy = rng.random((2, 24, 40)).astype(np.float32)
    args = (*flips, 1.07, 0.93, 0.01, 1234)
    got = native.augment_pair_f32(clean, noisy, *args)
    want = jnative.augment_pair_f32(clean, noisy, *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.shares_memory(got[0], clean)


def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def test_load_image_native_switch(tmp_path, monkeypatch):
    """PIL by default; the kernel with ``use_native=True`` or the
    environment's MIDD_TPU_NATIVE=1 (within 2 LSB of PIL); ``use_native``
    overrides the environment."""
    path = _png(tmp_path / "x.png", _u8(np.random.default_rng(3), (90, 70)))
    monkeypatch.delenv("MIDD_TPU_NATIVE", raising=False)
    plain = tdata.load_image(path, 48)
    pil = np.asarray(Image.open(path).convert("L").resize((48, 48), Image.BICUBIC), np.float32) / 255.0
    np.testing.assert_array_equal(plain[..., 0], pil)
    fast = tdata.load_image(path, 48, use_native=True)
    want = native.resize_bicubic_u8(np.asarray(Image.open(path).convert("L")), (48, 48)).astype(np.float32) / 255.0
    np.testing.assert_array_equal(fast[..., 0], want)
    assert fast.shape == plain.shape == (48, 48, 1) and fast.dtype == np.float32
    assert np.abs(fast - plain).max() <= PIL_LSB / 255.0 + 1e-7
    monkeypatch.setenv("MIDD_TPU_NATIVE", "1")
    np.testing.assert_array_equal(tdata.load_image(path, 48), fast)
    np.testing.assert_array_equal(tdata.load_image(path, 48, use_native=False), plain)


def test_native_path_raises_where_the_library_is_missing(tmp_path, monkeypatch):
    """No quiet fall back to PIL (the JAX package's load_image takes PIL)."""
    path = _png(tmp_path / "x.png", _u8(np.random.default_rng(4), (20, 20)))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    assert "no-such-compiler" in native.error()
    with pytest.raises(RuntimeError, match="unavailable"):
        tdata.load_image(path, 16, use_native=True)
    monkeypatch.setenv("MIDD_TPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tdata.load_image(path, 16)
    assert tdata.load_image(path, 16, use_native=False).shape == (16, 16, 1)


def _pairs(root, n=3, size=24):
    rng = np.random.default_rng(5)
    for d in ("clean", "noisy"):
        os.makedirs(root / d, exist_ok=True)
    for i in range(n):
        _png(root / "clean" / f"p{i}.png", _u8(rng, (size, size)))
        _png(root / "noisy" / f"p{i}.png", _u8(rng, (size, size)))
    return str(root / "clean"), str(root / "noisy")


def test_visualize_pairs_writes_its_png_and_leaves_the_draws(tmp_path):
    ds = tdata.PairedXRayDataset(*_pairs(tmp_path), img_size=16)
    state = ds.rng.bit_generator.state
    out = tmp_path / "pairs.png"
    tdata.visualize_pairs(ds, str(out))
    assert out.stat().st_size > 0 and Image.open(out).size[0] > 0
    assert ds.rng.bit_generator.state == state  # the training draws are as they were


def test_recipes_main_draws_the_figure_and_survives_its_failure(tmp_path, monkeypatch):
    clean, noisy = _pairs(tmp_path)
    monkeypatch.chdir(tmp_path)
    seen, trained = [], []
    monkeypatch.setattr(trecipes, "train_nafnet", lambda dataset, **kw: trained.append(dataset) or "state")
    monkeypatch.setattr(trecipes, "visualize_pairs", seen.append)
    argv = ["--model", "nafnet", "--clear-dir", clean, "--noisy-dirs", noisy, "--img-size", "16", "--device", "cpu"]
    assert trecipes.main(argv) == "state"
    assert seen == trained and len(seen) == 1

    def broken(dataset):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(trecipes, "visualize_pairs", broken)
    assert trecipes.main(argv) == "state"  # never fatal
