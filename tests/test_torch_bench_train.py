"""``bench_train_torch.py`` (the port's training benchmark) on the CPU at the
recipes' tiny widths, 16² and a 4-image pipeline (its module constants
patched): its JSON line, its FLOP count on the plain layout, and its
refusals."""

import json

import pytest
import torch

import bench_train_torch as btt
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils import flops

SMOKE = ["--device", "cpu", "--inner", "2", "--reps", "1", "--peak-tflops", "1.0"]
TINY_UNET = tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(btt, "MODEL_CFGS", {"diffusion": TINY_UNET, "nafnet": trecipes.TINY_NAFNET})
    monkeypatch.setattr(btt, "QUICK", {"diffusion": [(16, 2)], "nafnet": [(16, 2)]})
    monkeypatch.setattr(btt, "PIPELINE_CELL", (16, 2))
    monkeypatch.setattr(btt, "PIPELINE_IMGS", 4)


ROW_KEYS = {"model", "img", "batch", "ms_per_step", "imgs_per_s", "model_tflop_per_step", "mfu",
            "padded_tflop_per_step", "mfu_padded"}


def test_quick_line(tmp_path, monkeypatch, capsys):
    """One row a model, the pipeline rows, the pad tile and the device in
    the line; no file unless asked (bench_train.json is the TPU record)."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "line.json"
    result = btt.main(["--quick", *SMOKE, "--pad-tile", "64,16", "--json-out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result == json.loads(out.read_text())
    assert [(r["model"], r["img"], r["batch"]) for r in line["rows"]] == [("diffusion", 16, 2), ("nafnet", 16, 2)]
    for row in line["rows"]:
        assert set(row) == ROW_KEYS
        assert row["ms_per_step"] > 0 and row["imgs_per_s"] > 0
        assert 0 < row["mfu"] < row["mfu_padded"]  # padding only adds work
        assert row["mfu"] == pytest.approx(row["model_tflop_per_step"] * 1e12 / (row["ms_per_step"] / 1e3) / 1e12)
    assert line["pad_tile"] == [64, 16] and line["peak_tflops_assumed"] == 1.0
    assert line["device"] == "cpu" and line["nvidia_smi"] is None and line["remat_512_b2"] == {}
    assert set(line["pipeline"]) == {"diffusion", "nafnet"}
    assert all(p["wall_ms_per_step"] > 0 and p["occupancy"] > 0 for p in line["pipeline"].values())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["line.json"]


def test_count_is_the_plain_layout():
    """The diffusion step is counted on UNetDiffusion(fuse_updown=False,
    use_flash=False), the canonical layout, not the fused one it times."""
    model_f, padded_f = btt.step_flops("diffusion", 16, 2, torch.device("cpu"), (64, 16))
    unet = UNetDiffusion(TINY_UNET, fuse_updown=False, use_flash=False)
    fused = UNetDiffusion(TINY_UNET, use_flash=False)
    schedule = btt.make_schedule(tcfg.SERVE_SCHEDULE)
    clean = torch.zeros(2, 1, 16, 16)
    draw = ttrainer.diffusion_draw(schedule)((clean, clean), torch.Generator().manual_seed(0))
    loss_fn = ttrainer.diffusion_loss_fn(schedule)

    def step(model, pad=None):
        return flops.count_flops(lambda: loss_fn(model, (clean, clean), draw)[0].backward(), lane_pad=pad)

    assert model_f == step(unet) > step(fused)
    assert padded_f == step(unet, (64, 16)) > model_f


def test_nafnet_s2d_is_refused_naming_the_layouts():
    with pytest.raises(NotImplementedError, match="space-to-depth.*not ported, on purpose"):
        btt.main(["--models", "nafnet,nafnet_s2d", *SMOKE])
    with pytest.raises(ValueError, match="unknown models"):
        btt.main(["--models", "expert", *SMOKE])


def test_no_peak_for_the_cpu_unless_given():
    args = [a for a in SMOKE if a not in ("--peak-tflops", "1.0")]
    with pytest.raises(ValueError, match="no peak TFLOP/s for device cpu"):
        btt.main(["--quick", *args])


def test_step_trains_in_bf16_with_fp32_parameters():
    """The timed step: bf16 compute on fp32 parameters; finite losses."""
    model = btt.build("nafnet", torch.device("cpu"))
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    step = btt.make_step("diffusion", torch.device("cpu"))
    x = torch.rand(2, 1, 16, 16)
    losses = [float(step(x, x)) for _ in range(2)]
    assert all(torch.isfinite(torch.tensor(losses)))
