"""Tensor-parallel training in the port (``parallel/tp.py``'s process-group
form, ``TrainConfig.mesh_shape = (dp, 1, tp)``) against single-process
autograd, the port's one-process step and the JAX trainer over the same
mesh (``midd_tpu/train/trainer.py:314-347``) on the conftest's 8 virtual
CPU devices, at tiny widths with ``tp_min_size`` 64.

Two torchrun launches over gloo (``tests/_torch_tp_worker.py``), started
together by one module fixture:

- 2 ranks: (i) split convolution, depthwise convolution,
  ``ConvTranspose2d``, ``fused_updown`` and ``Linear`` layers (and a NAFNet
  with split ``beta``/``gamma``) in fp64 against single-process autograd:
  the output, dx and each slice's dw to 1e-12 of their scale; without the
  copy-in's all-reduce the input's and the upstream layer's gradients would
  hold one rank's part only; (ii) one NAFNet step at (1, 1, 2); (iii) the
  clip's global norm; (vi) the recipes CLI at ``--mesh 1,1,2`` for nafnet,
  diffusion, expert (BatchNorm) and hybrid (frozen backends);
- 4 ranks: (ii) the step at (2, 1, 2); (iv) a checkpoint saved at
  (2, 1, 2) and resumed at (4, 1, 1) and (1, 1, 4) (and here in one
  process), exactly, with one more epoch whose loss agrees to JAX's bound
  (``tests/test_sharded_checkpoint.py:103-110``); (v) the CLI's tp
  checkpoint served by the one-device engine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.parallel.mesh import count_tp_sharded as jcount_tp_sharded
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train.data import SyntheticPairedDataset
from tests import _torch_dp_worker as dpw
from tests import _torch_tp_worker as worker
from tests.test_torch_parallel import _env, _write_pairs
from tests.test_torch_serve import _small
from tests.torch_port_util import assert_step_matches, image, jax_init, nchw, perturb, rand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_tp_worker.py")
SIZE, BATCH, LR, WD = 16, 4, 1e-3, 1e-4
TINY_NAF = jcfg.NAFNetConfig(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
LAUNCH_TIMEOUT_S = 300
FP64_BOUND = 1e-12
NORM_REL = 1e-6  # fp32: the slices' squares summed in another order than the whole gradient's
RESUME_RTOL = 2e-4  # tests/test_sharded_checkpoint.py:103-110
MESHES = [(1, 1, 2), (2, 1, 2)]


def _launch(n: int, args: list, cwd: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                             str(n), WORKER, *args], env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _jax_step(mesh_shape, jmodel, variables, clean, noisy) -> dict:
    """The JAX trainer's step over ``mesh_shape``: loss, state_dict, split count."""
    cfg = jtrainer.TrainConfig(epochs=1, batch_size=BATCH, lr=LR, weight_decay=WD, mesh_shape=mesh_shape,
                               tp_min_size=worker.TP_MIN_SIZE)
    jt = jtrainer.Trainer(jtrainer.nafnet_loss_fn(jmodel), lambda *a: None, cfg, variables["params"])
    new, _, loss = jt._train_step(jt.state.params, jt.state.opt_state, (jnp.asarray(clean), jnp.asarray(noisy)),
                                  jax.random.PRNGKey(5))
    return {"loss": float(loss), "state": state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, new)}),
            "n_sharded": jcount_tp_sharded(jt._param_shardings)}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Both launches' per-rank records, the JAX steps, the port's
    one-process step (with its clip norm) and the job."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(12)
    jmodel = jm.EnhancedNAFNet(TINY_NAF)
    variables = perturb(jax_init(jmodel, jnp.zeros((1, SIZE, SIZE, 1)), seed=3), rng)
    clean = image(rng, BATCH, SIZE, SIZE, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
    job = {"batch": BATCH, "weight_decay": WD,
           "nafnet": {"state": state_dict_from_jax(variables), "clean": nchw(clean), "noisy": nchw(noisy)},
           "dataset": rng.random((8, SIZE, SIZE, 1)).astype(np.float32)}
    torch.save(job, tmp / "job.pt")
    dirs = _write_pairs(tmp)
    procs = {"tp2": _launch(2, ["tp2", str(tmp / "job.pt"), str(tmp), *dirs], str(tmp)),
             "tp4": _launch(4, ["tp4", str(tmp / "job.pt"), str(tmp)], str(tmp))}
    try:
        # meanwhile, in this process: the JAX steps and the port's one-process step
        jax_steps = {m: _jax_step(m, jmodel, variables, clean, noisy) for m in MESHES}
        single = worker._trainer(job, None, str(tmp / "unused"))
        with worker.recorded_norms() as norms:
            loss = single.train_step((job["nafnet"]["clean"], job["nafnet"]["noisy"]))
        single = {**dpw._record(single, loss), "norm": norms[-1]}
        outs = {k: p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, outs[k][-6000:]
    ranks = {k: [torch.load(tmp / f"{k}.rank{r}.pt", weights_only=False) for r in range(n)]
             for k, n in (("tp2", 2), ("tp4", 4))}
    return {"tmp": tmp, "job": job, "ranks": ranks, "jax": jax_steps, "single": single, "out": outs}


# -- (i) split layers in fp64 -----------------------------------------------------


@pytest.mark.parametrize("case, split", [
    ("chain", ["conv.weight", "dw.weight", "lin.weight", "up.weight", "updown.weight"]),
    ("nafnet_min16", ["middle_blks.0.beta", "middle_blks.0.gamma", "middle_blks.0.conv4.weight"]),
])
def test_split_layers_match_single_process_autograd_in_fp64(tp_runs, case, split):
    for rank in tp_runs["ranks"]["tp2"]:
        got = rank["layers"][case]
        assert set(split) <= set(got["split"]) and got["n_sharded"] > 0, got["split"]
        assert got["out"] <= FP64_BOUND and got["dx"] <= FP64_BOUND, (case, got["out"], got["dx"])
        worst = max(got["grads"], key=got["grads"].get)
        assert got["grads"][worst] <= FP64_BOUND, (case, worst, got["grads"][worst])


# -- (ii), (iii) one step against JAX and the port in one process -----------------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: ",".join(map(str, m)))
def test_tp_step_matches_the_jax_trainer_and_the_one_process_step(tp_runs, mesh):
    ranks = [r["step"] for r in tp_runs["ranks"]["tp2" if mesh[0] == 1 else "tp4"]]
    assert [r["rows"] for r in ranks] == ([(0, 4)] * 2 if mesh[0] == 1 else [(0, 2), (0, 2), (2, 2), (2, 2)])
    for r in ranks[1:]:  # every rank holds the same loss and, gathered, the same weights
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
    got, single, want = ranks[0], tp_runs["single"], tp_runs["jax"][mesh]
    assert got["n_sharded"] == want["n_sharded"] > 0
    assert set(got["state"]) == set(single["state"])
    assert_step_matches(got, single, f"tp {mesh} vs the port in one process", single["grads"], LR)
    assert_step_matches(got, want, f"tp {mesh} vs the JAX trainer", single["grads"], LR)


def test_whole_parameters_stay_equal_on_the_tp_ranks(tp_runs):
    """Gradients of the parameters every tp rank holds whole, moved a last
    bit apart per rank (as the card's atomics in the bilinear resize's
    backward move them), are averaged over the tp group before the update:
    the ranks keep equal copies."""
    a, b = (r["drift"] for r in tp_runs["ranks"]["tp2"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: ",".join(map(str, m)))
def test_clip_norm_at_tp_is_the_whole_gradients(tp_runs, mesh):
    ranks = tp_runs["ranks"]["tp2" if mesh[0] == 1 else "tp4"]
    want = tp_runs["single"]["norm"]
    for r in ranks:
        assert r["step"]["norm"] == pytest.approx(want, rel=NORM_REL), (r["step"]["norm"], want)


# -- (iv), (v) checkpoints across (dp, tp) ------------------------------------------


@pytest.fixture(scope="module")
def one_process_resume(tp_runs):
    """The (2, 1, 2) checkpoint resumed here in one process and trained one
    more epoch: (restored exactly, epoch after resume, losses)."""
    job = tp_runs["job"]
    path = tp_runs["ranks"]["tp4"][0]["resume"]["path"]
    tr = worker._trainer(job, None, str(tp_runs["tmp"] / "one_resumed"), epochs=2, batch=8)
    tr.resume(path)
    matches, epoch = dpw.restored_matches(tr, path), tr.state.epoch
    ds = SyntheticPairedDataset(job["dataset"], is_train=False, seed=7)
    tr.fit(ds, [ds[0]], verbose=False)
    return matches, epoch, tr.state.history["losses"]


@pytest.mark.parametrize("target", ["4,1,1", "1,1,4", "one process"])
def test_a_dp2_tp2_checkpoint_resumes_exactly_at_any_mesh(tp_runs, one_process_resume, target):
    src = tp_runs["ranks"]["tp4"]
    ckpt = torch.load(src[0]["resume"]["path"], weights_only=True)
    assert not any("shard." in k or "parametrizations" in k for k in ckpt["model_state_dict"])
    assert list(ckpt["model_state_dict"]) == list(EnhancedNAFNet(trecipes.TINY_NAFNET).state_dict())
    _, _, want = one_process_resume
    if target == "one process":
        matches, epoch, losses = one_process_resume
        runs = [(matches, epoch, losses)]
    else:
        key = tuple(int(x) for x in target.split(","))
        runs = [(r["resume"]["resumed"][key]["matches"], r["resume"]["resumed"][key]["epoch"],
                 r["resume"]["resumed"][key]["losses"]) for r in src]
    for matches, epoch, losses in runs:
        assert matches and epoch == 1
        assert losses[0] == src[0]["resume"]["src_losses"][0] and len(losses) == 2
        np.testing.assert_allclose(losses, want, rtol=RESUME_RTOL, err_msg=target)


def test_a_tp_checkpoint_serves_in_the_one_device_engine(tp_runs):
    """The CLI's nafnet.pth trained at --mesh 1,1,2 answers through the
    one-device engine as its weights do in the module."""
    ckpt_dir = tp_runs["tmp"] / "cli" / "nafnet" / "checkpoints"
    sd = torch.load(ckpt_dir / "nafnet.pth", weights_only=True)["model_state_dict"]
    eng = InferenceEngine(EngineConfig(**{**_small(tcfg), "nafnet_cfg": trecipes.TINY_NAFNET},
                                       diffusion_eval_bf16=False, hybrid_rollout_bf16=False,
                                       ckpt_dir=str(ckpt_dir), device="cpu"))
    try:
        assert not eng.meta["nafnet"].get("demo_weights") and eng.meta["nafnet"]["epoch"] == 0
        x = image(np.random.default_rng(4), 1, SIZE, SIZE, 1)
        model = EnhancedNAFNet(trecipes.TINY_NAFNET)
        model.load_state_dict(sd)
        with torch.no_grad():
            want = model.eval()(nchw(x)).clamp(0, 1).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(eng.fns["nafnet"](x), want, atol=1e-6)
    finally:
        eng.close()


@pytest.mark.parametrize("model", ["diffusion", "nafnet"])
def test_serve_presets_tp2_training_count_is_chip_smokes_constant(model):
    """The JAX trainer's ``count_tp_sharded`` at tp 2 (default
    ``tp_min_size``) for SERVE_DIFFUSION and SERVE_NAFNET, which
    ``chip_smoke.py`` phase 18 holds every rank's split count to; the
    port's rule gives the same."""
    import chip_smoke

    from midd_tpu.parallel.mesh import make_mesh as jmake_mesh
    from midd_tpu.parallel.mesh import param_shardings as jparam_shardings
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
    from midd_tpu_torch.parallel import count_tp_sharded, param_shardings

    x, t = jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,), jnp.int32)
    jmodel, args = ((jm.UNetDiffusion(jcfg.SERVE_DIFFUSION), (x, x, t)) if model == "diffusion"
                    else (jm.EnhancedNAFNet(jcfg.SERVE_NAFNET), (x,)))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args))["params"]
    for n in (2, 4):  # (1, 1, 2) and (2, 1, 2)
        want = jcount_tp_sharded(jparam_shardings(shapes, jmake_mesh(n, tp=2)))
        assert want == chip_smoke.TP2_TRAIN_SHARDED[model]
    with torch.device("meta"):
        port = UNetDiffusion(tcfg.SERVE_DIFFUSION) if model == "diffusion" else EnhancedNAFNet(tcfg.SERVE_NAFNET)
    assert count_tp_sharded(param_shardings(port, 2)) == chip_smoke.TP2_TRAIN_SHARDED[model]


# -- (vi) the CLI under torchrun ---------------------------------------------------


@pytest.mark.parametrize("model", worker.CLI_MODELS)
def test_every_recipe_trains_at_tp2_under_torchrun(tp_runs, model):
    ranks = tp_runs["ranks"]["tp2"]
    assert ranks[0]["cli"][model] == ranks[1]["cli"][model] > 0  # split layers, on both ranks
    ckpt = torch.load(tp_runs["tmp"] / "cli" / model / "checkpoints" / f"{model}.pth", weights_only=True)
    assert ckpt["epoch"] == 0 and all(np.isfinite(ckpt["losses"])), ckpt["losses"]
    # the single-process layout: the unsharded module's keys and shapes, and
    # AdamW's moments indexed by its parameters
    unsharded = _unsharded(model)
    unsharded.load_state_dict(ckpt["model_state_dict"], strict=True)
    opt = ckpt["optimizer_state_dict"]
    shapes = [p.shape for p in unsharded.parameters()]
    assert opt["param_groups"][0]["params"] == list(range(len(shapes)))
    assert [opt["state"][i]["exp_avg"].shape for i in range(len(shapes))] == shapes
    assert "backend gloo" in tp_runs["out"]["tp2"]


def _unsharded(model: str) -> torch.nn.Module:
    from midd_tpu_torch.models.direct_unet import ExpertDenoiser
    from midd_tpu_torch.models.hybrid import RouterFusion
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion

    hyb = trecipes.TINY_HYBRID
    return {"nafnet": lambda: EnhancedNAFNet(trecipes.TINY_NAFNET),
            "diffusion": lambda: UNetDiffusion(tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET)),
            "expert": lambda: ExpertDenoiser(trecipes.TINY_EXPERT),
            "hybrid": lambda: RouterFusion(hyb.router, hyb.fusion)}[model]()
