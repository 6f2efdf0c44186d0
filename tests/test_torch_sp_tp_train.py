"""Training at sp and tp together in the port (``TrainConfig.mesh_shape =
(dp, sp, tp)`` with sp > 1 and tp > 1: ``parallel/sp.py``'s row split over
``parallel/tp.py``'s channel split) against single-process autograd, the
port's one-process step and the UNSHARDED JAX trainer, at the tiny widths
of tests/test_torch_tp_train.py with ``tp_min_size`` 64.

The JAX trainer's own sp × tp step is wrong on XLA's CPU partitioner (a
NAFNet step's loss 3.378 at (1, 2, 2) and (2, 2, 2) against 1.185
unsharded; ROADMAP.md, "Read port results against these"), so the port is
held to the unsharded JAX step (``_jax_step(None, ...)``) and to its own
one-process step, never to JAX's sp × tp result.

Two torchrun launches over gloo (``tests/_torch_sp_tp_worker.py``), started
by one module fixture beside the JAX step and the port's one-process
steps: 4 ranks (the layers at (sp 2, tp 2) in fp64, the NAFNet, diffusion
and remat steps at (1, 2, 2), the CLI at ``--mesh 1,2,2`` for every
recipe, resumes at (1, 2, 2) and, parted into two groups of two, at
(1, 1, 2) and (1, 2, 1)) and 8 ranks (the (2, 2, 2) checkpoint, the
(2, 2, 2) step).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midd_tpu import models as jm
from midd_tpu.parallel.mesh import count_tp_sharded as jcount_tp_sharded
from midd_tpu.parallel.mesh import make_mesh as jmake_mesh
from midd_tpu.parallel.mesh import param_shardings as jparam_shardings
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.train import recipes as trecipes
from tests import _torch_dp_worker as dpw
from tests import _torch_sp_tp_worker as worker
from tests import _torch_sp_worker as spw
from tests import _torch_tp_worker as tpw
from tests.test_torch_parallel import _env, _write_pairs
from tests.test_torch_tp_train import (BATCH, FP64_BOUND, LR, NORM_REL, RESUME_RTOL, SIZE, TINY_NAF, _jax_step,
                                       _unsharded)
from tests.torch_port_util import assert_step_matches, image, jax_init, nchw, perturb, rand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sp_tp_worker.py")
LAUNCH_TIMEOUT_S = 300
MESHES = [(1, 2, 2), (2, 2, 2)]
LAUNCH = {(1, 2, 2): "sptp4", (2, 2, 2): "sptp8"}
NPROC = {"sptp4": 4, "sptp8": 8}


def _row_split_params(model: torch.nn.Module) -> int:
    """The parameters of every convolution but the NAFBlocks' SCA, which
    the sp split takes (``parallel/sp.py``)."""
    return sum(len(list(m.parameters(recurse=False))) for n, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and "sca" not in n.split("."))


def _unsharded_recipe(model: str) -> torch.nn.Module:
    """The tiny preset's module of a recipe, unsharded."""
    from midd_tpu_torch.models.tiny_unet import TinyUNet

    if model == "cddpm":
        return UNetDiffusion(tcfg.DiffusionUNetConfig(skip_mode="cddpm", **trecipes.TINY_UNET))
    if model == "tiny":
        return TinyUNet(tcfg.TinyUNetConfig(base_ch=8, time_dim=16))
    return _unsharded(model)


def _launch(n: int, args: list, cwd: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                             str(n), WORKER, *args], env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _diffusion_job(rng: np.random.Generator) -> dict:
    """The tiny diffusion UNet's seeded weights, a batch and its draws
    (t, x_t, eps) for the global batch."""
    model = init_weights(UNetDiffusion(tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET)),
                         torch.Generator().manual_seed(5))
    sched = make_schedule(tcfg.SERVE_SCHEDULE)
    clean = nchw(image(rng, BATCH, SIZE, SIZE, 1))
    noisy = torch.clamp(clean + 0.1 * nchw(rand(rng, BATCH, SIZE, SIZE, 1)), 0, 1)
    t = torch.from_numpy(rng.integers(1, sched.noise_steps, BATCH)).long()
    eps = nchw(rng.standard_normal((BATCH, SIZE, SIZE, 1)).astype(np.float32))
    ah = sched.alpha_hat[t].reshape(-1, 1, 1, 1).float()
    x_t = ah.sqrt() * clean + (1 - ah).sqrt() * eps
    return {"state": model.state_dict(), "clean": clean, "noisy": noisy, "draw": (t, x_t, eps)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches' per-rank records, the unsharded JAX step and JAX's
    split count at (1, 1, 2), the port's one-process steps (with the clip's
    norm) and the job."""
    tmp = tmp_path_factory.mktemp("sptp")
    rng = np.random.default_rng(12)
    jmodel = jm.EnhancedNAFNet(TINY_NAF)
    variables = perturb(jax_init(jmodel, jnp.zeros((1, SIZE, SIZE, 1)), seed=3), rng)
    clean = image(rng, BATCH, SIZE, SIZE, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
    job = {"batch": BATCH, "weight_decay": 1e-4,
           "nafnet": {"state": state_dict_from_jax(variables), "clean": nchw(clean), "noisy": nchw(noisy)},
           "diffusion": _diffusion_job(rng), "dataset": rng.random((8, SIZE, SIZE, 1)).astype(np.float32)}
    one = worker._trainer(job, None, str(tmp / "one_src"), batch=8)  # (v): a one-process .pth to resume
    ds = spw._dataset(job)
    one.fit(ds, [ds[0]], verbose=False)
    job["one_pth"] = one.save({"tag": "one"})
    torch.save(job, tmp / "job.pt")
    dirs = _write_pairs(tmp)
    procs = {"sptp8": _launch(8, ["sptp8", str(tmp / "job.pt"), str(tmp)], str(tmp)),
             "sptp4": _launch(4, ["sptp4", str(tmp / "job.pt"), str(tmp), *dirs], str(tmp))}
    try:
        # meanwhile, in this process: the unsharded JAX step and the port's one-process steps
        jax_step = _jax_step(None, jmodel, variables, clean, noisy)
        jax_step["n_sharded"] = jcount_tp_sharded(jparam_shardings(variables["params"], jmake_mesh(2, tp=2),
                                                                   min_size=tpw.TP_MIN_SIZE))
        single = {}
        for name in ("nafnet", "diffusion"):
            tr = worker._trainer(job, None, str(tmp / "unused"), name=name)
            with tpw.recorded_norms() as norms:
                loss = tr.train_step((job[name]["clean"], job[name]["noisy"]))
            single[name] = {**dpw._record(tr, loss), "norm": norms[-1]}
        outs = {k: p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, outs[k][-6000:]
    ranks = {k: [torch.load(tmp / f"{k}.rank{r}.pt", weights_only=False) for r in range(n)]
             for k, n in NPROC.items()}
    return {"tmp": tmp, "job": job, "ranks": ranks, "jax": jax_step, "single": single, "out": outs}


# -- (i) the layers in fp64 ----------------------------------------------------------


def test_sp_tp_layers_match_single_process_autograd_in_fp64(runs):
    """Every convolution kind, ``fused_updown``'s derived convolution, a
    ``Linear`` and a split per-channel ``beta``/``gamma`` at (sp 2, tp 2) on
    an odd height (uneven row blocks): the output, dx and every gradient
    after the step's reductions within 1e-12 of their scale."""
    for got in (r["layers"] for r in runs["ranks"]["sptp4"]):
        assert got["n_sharded"] == 11 and {"beta", "gamma", "lin.weight", "updown.weight"} <= set(got["split"])
        assert len(got["summed"]) == 16, got["summed"]  # 8 convolutions' weights and biases: not lin's, beta, gamma
        assert got["shapes"] == [(2, 4, 12, 8), (2, 6)]
        assert got["out"] <= FP64_BOUND and got["dx"] <= FP64_BOUND, (got["out"], got["dx"])
        worst = max(got["grads"], key=got["grads"].get)
        assert got["grads"][worst] <= FP64_BOUND, (worst, got["grads"][worst])


# -- (ii)-(iv), (vii) one step against the unsharded JAX trainer and one process -------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: ",".join(map(str, m)))
def test_sp_tp_step_matches_the_unsharded_jax_trainer_and_the_one_process_step(runs, mesh):
    ranks = [r["step"] for r in runs["ranks"][LAUNCH[mesh]]]
    if mesh[0] == 1:
        assert [r["image_sharding"] for r in ranks] == [(0, 4, s, 2) for s in (0, 0, 1, 1)]
    else:
        assert [r["image_sharding"] for r in ranks] == [(d, 2, s, 2) for d in (0, 2) for s in (0, 0, 1, 1)]
    for r in ranks[1:]:  # every rank holds the same loss and, gathered, the same weights
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
    got, single, want = ranks[0], runs["single"]["nafnet"], runs["jax"]
    assert got["n_sharded"] == want["n_sharded"] > 0
    assert got["summed"] == _row_split_params(EnhancedNAFNet(trecipes.TINY_NAFNET))
    assert set(got["state"]) == set(single["state"])
    assert_step_matches(got, single, f"sp x tp {mesh} vs the port in one process", single["grads"], LR)
    assert_step_matches(got, want, f"sp x tp {mesh} vs the unsharded JAX trainer", single["grads"], LR)


def test_diffusion_step_at_sp_tp_matches_the_one_process_step(runs):
    ranks = [r["diffusion"] for r in runs["ranks"]["sptp4"]]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
    got, single = ranks[0], runs["single"]["diffusion"]
    assert got["n_sharded"] > 0 and got["summed"] > 0
    assert_step_matches(got, single, "diffusion (1, 2, 2) vs the port in one process", single["grads"], LR)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: ",".join(map(str, m)))
def test_clip_norm_at_sp_tp_is_the_whole_gradients(runs, mesh):
    want = runs["single"]["nafnet"]["norm"]
    for r in runs["ranks"][LAUNCH[mesh]]:
        assert r["step"]["norm"] == pytest.approx(want, rel=NORM_REL), (r["step"]["norm"], want)


def test_whole_parameters_stay_equal_on_every_sp_tp_rank(runs):
    """The whole parameters' gradients moved a last bit apart per rank are
    summed or averaged over sp and averaged over tp before the update: the
    four ranks keep equal copies."""
    first, *rest = (r["drift"] for r in runs["ranks"]["sptp4"])
    for other in rest:
        assert other.keys() == first.keys()
        for k in first:
            assert torch.equal(other[k], first[k]), k


def test_remat_at_sp_tp_gives_the_same_step(runs):
    """``TrainConfig(remat=True)`` recomputes the forward, its all-gathers
    included, in the backward: the same loss, gradients and weights."""
    for r in runs["ranks"]["sptp4"]:
        plain, remat = r["step"], r["remat"]
        assert remat["loss"] == plain["loss"] and remat["norm"] == plain["norm"]
        for k, v in plain["state"].items():
            assert torch.equal(remat["state"][k], v), k


# -- (v) checkpoints across meshes -----------------------------------------------------


@pytest.fixture(scope="module")
def one_process_resume(runs):
    """The (2, 2, 2) checkpoint resumed here in one process and trained one
    more epoch: (restored exactly, epoch after resume, losses)."""
    job = runs["job"]
    path = runs["ranks"]["sptp8"][0]["resume_src"]["path"]
    tr = worker._trainer(job, None, str(runs["tmp"] / "one_resumed"), epochs=2, batch=8)
    tr.resume(path)
    matches, epoch = dpw.restored_matches(tr, path), tr.state.epoch
    ds = spw._dataset(job)
    tr.fit(ds, [ds[0]], verbose=False)
    return matches, epoch, tr.state.history["losses"]


@pytest.mark.parametrize("target", ["one process", "1,2,2", "1,1,2", "1,2,1"])
def test_a_dp2_sp2_tp2_checkpoint_resumes_exactly_at_any_mesh(runs, one_process_resume, target):
    src = runs["ranks"]["sptp8"][0]["resume_src"]
    ckpt = torch.load(src["path"], weights_only=True)
    assert list(ckpt["model_state_dict"]) == list(EnhancedNAFNet(trecipes.TINY_NAFNET).state_dict())
    assert [p.shape for p in ckpt["model_state_dict"].values()] == [
        p.shape for p in EnhancedNAFNet(trecipes.TINY_NAFNET).state_dict().values()]
    _, _, want = one_process_resume
    if target == "one process":
        runs_at = [one_process_resume]
    else:
        key = tuple(int(x) for x in target.split(","))
        held = [r["resume"][key] for r in runs["ranks"]["sptp4"] if key in r["resume"]]
        assert len(held) == (4 if key == (1, 2, 2) else 2), target
        runs_at = [(h["matches"], h["epoch"], h["losses"]) for h in held]
    for matches, epoch, losses in runs_at:
        assert matches and epoch == 1
        assert losses[0] == src["src_losses"][0] and len(losses) == 2
        np.testing.assert_allclose(losses, want, rtol=RESUME_RTOL, err_msg=target)


def test_a_one_process_checkpoint_resumes_exactly_at_sp2_tp2(runs):
    for r in runs["ranks"]["sptp4"]:
        got = r["resume_one"]
        assert got["matches"] and got["epoch"] == 1 and len(got["losses"]) == 2, got


# -- (vi) the CLI under torchrun --------------------------------------------------------


@pytest.mark.parametrize("model", worker.CLI_MODELS)
def test_every_recipe_trains_at_sp2_tp2_under_torchrun(runs, model):
    ranks = runs["ranks"]["sptp4"]
    counts = [r["cli"][model] for r in ranks]
    assert all(c == counts[0] for c in counts) and counts[0]["n_sharded"] > 0 and counts[0]["summed"] > 0, counts
    ckpt = torch.load(runs["tmp"] / "cli" / model / "checkpoints" / f"{model}.pth", weights_only=True)
    assert ckpt["epoch"] == 0 and all(np.isfinite(ckpt["losses"])), ckpt["losses"]
    unsharded = _unsharded_recipe(model)
    unsharded.load_state_dict(ckpt["model_state_dict"], strict=True)
    opt = ckpt["optimizer_state_dict"]
    shapes = [p.shape for p in unsharded.parameters()]
    assert opt["param_groups"][0]["params"] == list(range(len(shapes)))
    assert [opt["state"][i]["exp_avg"].shape for i in range(len(shapes))] == shapes
    assert "backend gloo" in runs["out"]["sptp4"]
