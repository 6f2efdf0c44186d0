"""The benchmark's plain reference against the port's engine, on the CPU at
64x64: the same seeded checkpoints and the same uploads give the same four
answers. The port runs with its UNet evals in fp32 here (its served bf16
evals are what the chip comparison judges), so the two differ by rounding."""

import base64
import io
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from perfbench import inputs, weights
from perfbench.reference import models as ref
from perfbench.reference import serve as ref_serve

CFG = json.loads((Path(__file__).parents[1] / "configs" / "xray512_b8.json").read_text())
SIZE = 64


@pytest.fixture(scope="module")
def served():
    from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = {**CFG, "img_size": SIZE}
    states = weights.draw(cfg, 2**31 + 7, "cpu")
    with tempfile.TemporaryDirectory() as d:
        weights.save(cfg, states, d)
        engine = InferenceEngine(EngineConfig(img_size=SIZE, ckpt_dir=d, device="cpu",
                                              diffusion_eval_bf16=False, hybrid_rollout_bf16=False,
                                              warmup=False))
    yield cfg, states, engine
    engine.close()


def test_published_widths():
    assert {k: sum(p.numel() for p in m.parameters()) for k, m in ref.build(CFG, "meta").items()} == {
        "diffusion": CFG["params"]["diffusion"], "nafnet": CFG["params"]["nafnet"],
        "expert": CFG["params"]["expert"], "hybrid": CFG["params"]["hybrid_router_fusion"]}


def test_paths_match_the_port(served):
    cfg, states, engine = served
    assert all(not m.get("demo_weights") for m in engine.meta.values())
    x = np.stack([inputs.noisy_image(np.random.default_rng(i), SIZE, SIZE, fam)
                  for i, fam in enumerate(inputs.FAMILIES)])[..., None].astype(np.float32)
    ours = ref_serve.paths(ref.load(cfg, states, "cpu"), cfg, torch.from_numpy(x).permute(0, 3, 1, 2))
    for name in ref_serve.PATHS:
        port = engine.fns[name](x)[..., 0]
        np.testing.assert_allclose(ours[name][:, 0].numpy(), port, atol=2e-4, err_msg=name)
        assert ours[name].std() > 0.02, name  # the draw keeps the answer off the clamps


def test_answers_match_the_port(served):
    cfg, states, engine = served
    uploads = [inputs.upload(2**31 + 7, i, SIZE, 3) for i in range(3)]
    ours = ref_serve.answer(ref.load(cfg, states, "cpu"), cfg, uploads, "cpu")
    for up, want in zip(uploads, ours):
        x, size = ref_serve.decode(up, SIZE)
        got = engine.process_all(x[None, :, :, None], size)
        for name in ref_serve.PATHS:
            png = np.asarray(Image.open(io.BytesIO(base64.b64decode(got[name]))))
            assert png.shape == want[name].shape
            assert np.abs(png.astype(int) - want[name]).max() <= 1, name
