"""The port's xraybench-v1 (``midd_tpu_torch/benchmarks/xray_bench.py``)
against the JAX package's, on the CPU at tiny widths.

(a) ``make_eval_set`` and the first items of ``make_train_dataset`` (mixed
    and single noise, with and without ``noise_seed``) are bit-equal to JAX's.
(b) On the same predictions ``score_fn`` agrees with JAX's to 1e-5 in PSNR
    and SSIM, the exact-reconstruction rule included; ``format_table`` gives
    JAX's string.
(c) ``score_engine`` on the port's and the JAX engine loaded with the same
    weights, fp32 and exact rollouts, agrees overall.
(d) ``train_all`` and the variants' trainers call the recipes with JAX's
    numbers; ``train_all`` (tiny, the tpu profile, 2 epochs) writes every
    checkpoint with its completion marker; ``main()`` prints the table and JAX's
    payload keys; the CLI takes every flag of the JAX one plus ``--device``.
(e) ``seed_study`` retrains an unmarked run and reuses a marked one, a
    missing link source raises before any training, and ``score_variant``
    leaves no view directory behind.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from midd_tpu import config as jcfg
from midd_tpu.benchmarks import xray_bench as jxb
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.benchmarks import xray_bench as txb
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import recipes
from midd_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_serve import NAF, UNET, _tiny, _write_checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False,
             turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1)


# -- (a) data -------------------------------------------------------------------


def test_eval_set_is_bit_equal():
    got, want = txb.make_eval_set(2, 32), jxb.make_eval_set(2, 32)
    assert len(got) == len(want) == 6
    for (gc, gn, gt), (wc, wn, wt) in zip(got, want):
        assert gt == wt and gc.dtype == wc.dtype and gn.dtype == wn.dtype
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gn, wn)
    assert txb.PROTOCOL_VERSION == jxb.PROTOCOL_VERSION
    assert (txb.EVAL_SEED, txb.TRAIN_SEED, txb.NOISE_TYPES) == (jxb.EVAL_SEED, jxb.TRAIN_SEED, jxb.NOISE_TYPES)


@pytest.mark.parametrize("noise_type,noise_seed", [("mixed", None), ("mixed", 7042785),
                                                   ("poisson", None), ("speckle", 99)])
def test_train_dataset_items_are_bit_equal(noise_type, noise_seed):
    got = txb.make_train_dataset(6, 32, noise_type=noise_type, noise_seed=noise_seed)
    want = jxb.make_train_dataset(6, 32, noise_type=noise_type, noise_seed=noise_seed)
    assert len(got) == len(want) == 6
    for i in (0, 1, 2, 3, 2):  # in call order: the draw stream is sequential
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)


# -- (b) scoring ------------------------------------------------------------------


def test_score_fn_and_format_table_match_jax():
    eval_set = txb.make_eval_set(2, 32)
    rng = np.random.default_rng(3)

    def fn(noisy):  # a fixed "denoiser"; the first image reconstructed exactly
        out = np.clip(noisy + 0.02 * rng.standard_normal(noisy.shape), 0, 1).astype(np.float32)
        return out

    preds = {}

    def recorded(noisy):
        key = noisy.tobytes()
        if key not in preds:
            preds[key] = fn(noisy)
            if len(preds) == 1:
                preds[key][0] = eval_set[0][0]  # an exact reconstruction
        return preds[key]

    got = txb.score_fn(recorded, eval_set)
    want = jxb.score_fn(lambda x: recorded(np.asarray(x)), eval_set)
    assert list(got) == list(want)
    for k in want:
        assert got[k]["n"] == want[k]["n"]
        np.testing.assert_allclose(got[k]["psnr"], want[k]["psnr"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[k]["ssim"], want[k]["ssim"], atol=1e-5, rtol=0)
    # every image exact: psnr None, ssim 1
    exact = [e for e in eval_set if e[2] == "gaussian"]
    got_x = txb.score_fn(lambda x: np.stack([e[0] for e in exact[: len(x)]]), exact)
    want_x = jxb.score_fn(lambda x: np.stack([e[0] for e in exact[: len(x)]]), exact)
    assert got_x["overall"]["psnr"] is None and want_x["overall"]["psnr"] is None
    assert got_x["overall"]["ssim"] == pytest.approx(want_x["overall"]["ssim"], abs=1e-5)
    results = {"_input": want, "exact": want_x, "x": {"overall": want["overall"]}}
    assert txb.format_table(results) == jxb.format_table(results)


# -- (c) score_engine against the JAX engine -------------------------------------


def test_score_engine_matches_the_jax_engine(tmp_path):
    """Same weights (JAX-initialised, through ``state_dict_from_jax``), exact
    fp32 rollouts. The outputs agree to ~1e-6 per pixel on the NAFNet and
    expert paths and within the engine parity test's 1e-3 on the rollouts
    (test_torch_serve.py), where the typical difference is ~1e-5; with these
    untrained outputs ~0.3 from clean, such a difference moves a mean PSNR
    by ~1e-4 dB and an SSIM by ~1e-6: 1e-3 dB and 1e-5 hold them, while
    one wrong layer would not fit."""
    _write_checkpoints(str(tmp_path), np.random.default_rng(11))
    eval_set = txb.make_eval_set(1, 32)
    jeng = JEngine(JEngineConfig(**_tiny(jcfg), **EXACT, ckpt_dir=str(tmp_path), persistent_cache=False))
    teng = InferenceEngine(EngineConfig(**_tiny(tcfg), **EXACT, ckpt_dir=str(tmp_path), device="cpu"))
    try:
        got = txb.score_engine(teng, eval_set)
    finally:
        teng.close()
    want = jxb.score_engine(jeng, eval_set)
    assert list(got) == list(want) == ["_input", "diffusion", "nafnet", "expert", "hybrid"]
    for name in want:
        g, w = got[name]["overall"], want[name]["overall"]
        assert g["n"] == w["n"] == 3
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3, (name, g, w)
        assert abs(g["ssim"] - w["ssim"]) <= 1e-5, (name, g, w)


# -- (d) training and the CLI ----------------------------------------------------


def _recording_recipes(monkeypatch, module, calls, write_pth):
    """Replace ``module``'s four recipes with ones that record each call's
    ``TrainConfig`` (all but ``ckpt_dir``) and options; ``write_pth``: also
    write an empty ``<ckpt_name>.pth``, as the port's markers need one."""

    def recorder(model):
        def fn(*args, **kwargs):
            cfg = kwargs.get("train_cfg", args[2] if len(args) > 2 else None)
            fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "ckpt_dir"}
            opts = {k: kwargs[k] for k in ("loss_variant", "val_inference_steps") if k in kwargs}
            for k in ("init_from", "nafnet_ckpt", "diffusion_ckpt", "expert_ckpt"):
                if kwargs.get(k) is not None:
                    opts[k] = os.path.basename(kwargs[k])
            calls.append((model, fields, opts))
            if write_pth:
                open(os.path.join(cfg.ckpt_dir, f"{cfg.ckpt_name}.pth"), "wb").close()
        return fn

    for model in ("nafnet", "diffusion", "expert", "hybrid"):
        monkeypatch.setattr(module, f"train_{model}", recorder(model))


@pytest.mark.parametrize("hybrid_profile", ["reference", "tpu"])
def test_training_recipes_are_the_jax_benchmarks(tmp_path, monkeypatch, hybrid_profile):
    """train_all, train_wide_standalone and train_ddim50_faithful call the
    recipes in JAX's order with JAX's ``TrainConfig`` numbers at an epoch
    scale of 0.5, and with its loss variants, initial weights and backends."""
    from midd_tpu.train import recipes as jrecipes

    got, want = [], []
    _recording_recipes(monkeypatch, recipes, got, write_pth=True)
    _recording_recipes(monkeypatch, jrecipes, want, write_pth=False)
    for run, mod, calls in (("port", txb, got), ("jax", jxb, want)):
        d = str(tmp_path / run)
        os.makedirs(d)
        kw = dict(img_size=32, n_train=2, epochs_scale=0.5)
        mod.train_all(d, width_preset="tiny", hybrid_profile=hybrid_profile, **kw)
        mod.train_wide_standalone(d, **kw)
        mod.train_ddim50_faithful(d, **kw)
    assert [c[0] for c in got] == [c[0] for c in want]
    assert got == want
    assert [c[1]["epochs"] for c in got if c[0] == "diffusion"] == [15, 15, 15]


def test_train_all_marks_and_main_prints_the_jax_payload(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the recipes write their curves to the working directory
    ckpt = str(tmp_path / "ck")
    txb.train_all(ckpt, img_size=32, n_train=4, epochs_scale=0.01, width_preset="tiny",
                  hybrid_profile="tpu", device="cpu")
    phases = {"nafnet": ["reference", "l2"], "diffusion": ["diffusion"], "expert": ["reference"],
              "expert_ftl2": ["l2"], "hybrid": ["hybrid"]}
    for name, want in phases.items():
        assert tuple(want) == txb.completed_phases(ckpt, name), name
        ck = torch.load(os.path.join(ckpt, f"{name}.pth"), weights_only=True)
        assert ck["epoch"] == 1 and len(ck["losses"]) == 2, name  # the 2-epoch floor
    hyb = torch.load(os.path.join(ckpt, "hybrid.pth"), weights_only=True)
    assert hyb["fusion_params"]["sees_expert"] and hyb["fusion_params"]["residual"]
    assert {k.split(".")[0] for k in hyb["model_state_dict"]} == {"router", "fusion"}
    capsys.readouterr()

    payload = txb.main(["--ckpt-dir", ckpt, "--device", "cpu", "--width-preset", "tiny",
                        "--img-size", "32", "--n-eval", "1", "--json-out", str(tmp_path / "p.json")])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == payload == json.load(open(tmp_path / "p.json"))
    assert list(payload) == ["protocol", "img_size", "n_eval", "results"]  # xray_bench.py:744-745
    assert payload["protocol"] == "xraybench-v1" and payload["n_eval"] == 3
    rows = ["_input", "diffusion", "nafnet", "expert", "hybrid", "expert_ftl2(branch)"]
    assert list(payload["results"]) == rows
    table = jxb.format_table(payload["results"]).splitlines()
    assert out[-3 - len(rows) : -1] == table
    for r in payload["results"].values():
        assert all(np.isfinite(v["psnr"]) and np.isfinite(v["ssim"]) for v in r.values())


def _flags(help_text: str) -> set:
    return set(re.findall(r"(--[a-z0-9][a-z0-9-]*)", help_text))


def test_cli_takes_every_jax_flag(capsys):
    jax_help = subprocess.run([sys.executable, "-m", "midd_tpu.benchmarks.xray_bench", "--help"],
                              capture_output=True, text=True, cwd=REPO, timeout=300, check=True).stdout
    with pytest.raises(SystemExit):
        txb.main(["--help"])
    ours = _flags(capsys.readouterr().out)
    assert len(_flags(jax_help)) >= 18
    assert ours == _flags(jax_help) | {"--device"}


# -- (e) the seed study and score_variant ----------------------------------------


TINY_KW = dict(img_size=32, warmup=False, device="cpu",
               nafnet_cfg=tcfg.NAFNetConfig(**NAF), diffusion_cfg=tcfg.DiffusionUNetConfig(**UNET),
               expert_cfg=tcfg.ExpertConfig(base_channels=8), router_cfg=tcfg.RouterConfig(base_c=8),
               fusion_cfg=tcfg.FusionConfig(base_c=16))


def _tiny_diffusion(path, seed):
    model = init_weights(UNetDiffusion(tcfg.DiffusionUNetConfig(**UNET)), torch.Generator().manual_seed(seed))
    save_checkpoint(path, model.state_dict(), metadata={**UNET, "noise_steps": 50, "epoch": 1})


@pytest.fixture
def fake_training(monkeypatch):
    """Recipes that record their calls and write a tiny checkpoint."""
    calls = []

    def train_diffusion(ds, model_cfg, train_cfg, device):
        calls.append(("diffusion", train_cfg.ckpt_name, train_cfg.seed, device))
        _tiny_diffusion(os.path.join(train_cfg.ckpt_dir, f"{train_cfg.ckpt_name}.pth"), 100 + train_cfg.seed)

    def train_hybrid(*args, **kwargs):
        calls.append(("hybrid",))

    monkeypatch.setattr(recipes, "train_diffusion", train_diffusion)
    monkeypatch.setattr(recipes, "train_hybrid", train_hybrid)
    return calls


def test_seed_study_retrains_unmarked_runs_and_reuses_marked(tmp_path, fake_training, capsys):
    ckpt = str(tmp_path)
    _tiny_diffusion(os.path.join(ckpt, "diffusion.pth"), 1)
    _tiny_diffusion(os.path.join(ckpt, "seed_study", "diffusion_s1.pth"), 2)  # interrupted: no marker
    eval_set = txb.make_eval_set(1, 32)
    kw = dict(img_size=32, n_train=2, epochs_scale=0.01, base_kw=TINY_KW)

    first = txb.seed_study(ckpt, ["diffusion"], 1, eval_set, **kw)
    assert fake_training == [("diffusion", "diffusion_s1", 1, "cpu")]
    assert "diffusion_s1: retraining a run that is not marked finished" in capsys.readouterr().err
    assert txb.completed_phases(os.path.join(ckpt, "seed_study"), "diffusion_s1") == ("diffusion",)
    assert [r["seed"] for r in first["diffusion"]["rows"]] == [0, 1] and first["diffusion"]["n"] == 2

    again = txb.seed_study(ckpt, ["diffusion"], 1, eval_set, **kw)
    assert len(fake_training) == 1  # nothing trained
    assert "diffusion_s1: reusing the finished run (diffusion)" in capsys.readouterr().err
    assert again == first


def test_seed_study_checks_its_sources_before_training(tmp_path, fake_training):
    ckpt = str(tmp_path)
    for name in ("hybrid", "nafnet", "diffusion", "expert"):  # no expert_ftl2
        _tiny_diffusion(os.path.join(ckpt, f"{name}.pth"), 3)
    with pytest.raises(FileNotFoundError, match=r"expert_ftl2\.pth"):
        txb.seed_study(ckpt, ["hybrid"], 1, txb.make_eval_set(1, 32), base_kw=TINY_KW)
    assert fake_training == []
    assert not os.path.exists(os.path.join(ckpt, "seed_study"))


def test_score_variant_leaves_no_view_directory(tmp_path, monkeypatch):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    ckpt = tmp_path / "ck"
    _tiny_diffusion(str(ckpt / "diffusion_w96.pth"), 4)
    eval_set = txb.make_eval_set(1, 32)
    r = txb.score_diffusion_variant(str(ckpt), "diffusion_w96", eval_set, 2, TINY_KW)
    assert np.isfinite(r["overall"]["psnr"]) and os.listdir(tmp) == []
    # an engine that fails to load the source: the view goes all the same
    torch.save({"model_state_dict": {"nonsense": torch.zeros(1)}}, str(ckpt / "broken.pth"))
    with pytest.raises(RuntimeError):
        txb.score_variant(str(ckpt), {"diffusion": "broken"}, "diffusion", eval_set, TINY_KW)
    assert os.listdir(tmp) == []
    # a missing source raises before a view is made; an orbax one names the bridge
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        txb.score_variant(str(ckpt), {"diffusion": "absent"}, "diffusion", eval_set, TINY_KW)
    (ckpt / "orbax_tree").mkdir()
    with pytest.raises(NotImplementedError, match="orbax_bridge.py to-pth"):
        txb.score_variant(str(ckpt), {"diffusion": "orbax_tree"}, "diffusion", eval_set, TINY_KW)
    assert os.listdir(tmp) == []
