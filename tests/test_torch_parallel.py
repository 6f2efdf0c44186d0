"""The port's data-parallel layer (``midd_tpu_torch/parallel``) against the
JAX package's, on the CPU:

(a) the mesh layouts, their errors, the fabric report and the batch rows
    against ``midd_tpu.parallel`` on the conftest's 8 virtual devices;
(b) ``init_distributed``: a no-op when nothing is configured, and a dead
    coordinator raises within its bound (in a subprocess);
(c) one dp-2 train step in two gloo ranks (``tests/_torch_dp_worker.py``,
    rendezvous through a file under ``tmp_path``) for a tiny NAFNet, expert
    (global-batch BatchNorm statistics) and diffusion UNet (global-batch
    draws), against the JAX sharded step over a dp-2 mesh and the port's
    single-process step; a NaN in one rank's rows skipped on both; a
    ``.pth`` written at dp 2 resumed in one process and the reverse;
(d) the recipes CLI under ``torchrun --mesh 2,1,1``: all six recipes train,
    three of them against the same CLI in one process, and a dp-2
    checkpoint resumes in one process (one resumed the other way in the
    ranks); sp > 1 is refused naming the ROADMAP item.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.diffusion import make_schedule as jmake_schedule
from midd_tpu.diffusion import noise_images as jnoise_images
from midd_tpu.diffusion import sample_timesteps as jsample_timesteps
from midd_tpu.parallel import make_mesh as jmake_mesh
from midd_tpu.parallel import make_sharded_train_step as jsharded_step
from midd_tpu.parallel import multihost as jmulti
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.parallel import mesh as tmesh
from midd_tpu_torch.parallel import multihost as tmulti
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from tests import _torch_dp_worker as worker
from tests.torch_port_util import assert_step_matches, image, jax_init, nchw, perturb, rand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dp_worker.py")
SIZE, BATCH, LR, WD = 16, 4, 1e-3, 1e-4
TINY_NAF = jcfg.NAFNetConfig(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
TINY_UNET = jcfg.DiffusionUNetConfig(**trecipes.TINY_UNET)
RANK_TIMEOUT_S = 240


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return env


def _run(cmds, cwd=None) -> list:
    """Run the commands at once, each bounded; every one must succeed."""
    procs = [subprocess.Popen(c, env=_env(), cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


# -- (a) layouts ------------------------------------------------------------------


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("n, tp, sp", [(8, None, 1), (8, 2, 1), (8, 1, 4), (8, None, 2), (6, None, 1),
                                       (4, None, 1), (2, 1, 1), (1, None, 1)])
def test_make_mesh_layout_matches_jax(n, tp, sp):
    np.testing.assert_array_equal(tmesh.mesh_layout(n, tp, sp, ranks=range(8)),
                                  _ids(jmake_mesh(n, tp=tp, sp=sp)))


@pytest.mark.parametrize("tp, sp, per", [(2, 1, 4), (2, 2, 4), (4, 1, None), (1, 1, 2), (1, 2, 2), (2, 1, 2),
                                         (4, 1, 2), (3, 1, None), (1, 1, 3)])
def test_make_hybrid_mesh_layout_and_fabric_match_jax(monkeypatch, tp, sp, per):
    """The slice-major layout and the fabric report, or the same ValueError
    (its first clause: the JAX message names TPU fabrics after it)."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    try:
        jmesh = jmulti.make_hybrid_mesh(tp=tp, sp=sp, devices_per_slice=per)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmulti.hybrid_mesh_layout(tp, sp, ranks=range(8), devices_per_slice=per)
        assert str(got.value).split(":")[0] == str(e).split(":")[0]
        return
    layout = tmulti.hybrid_mesh_layout(tp, sp, ranks=range(8), devices_per_slice=per)
    np.testing.assert_array_equal(layout, _ids(jmesh))
    assert tmulti.mesh_fabric_report(layout, per) == jmulti.mesh_fabric_report(jmesh, per)


@pytest.mark.parametrize("args", [(16,), (16, 4, 0), (16, 4, 3), (12, 2, 1), (10, 4, 0)])
def test_process_batch_slice_matches_jax(args):
    try:
        want = jmulti.process_batch_slice(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tmulti.process_batch_slice(*args)
        return
    assert tmulti.process_batch_slice(*args) == want


# -- (b) init_distributed ---------------------------------------------------------


def test_init_distributed_is_a_noop_when_nothing_is_configured(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmulti.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_fails_fast_on_a_dead_coordinator():
    """A configured launch that cannot connect raises within its bound
    (1 s here; the store's retries take a few more), and never falls
    through to a single process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # bound to nothing once closed
    code = ("from midd_tpu_torch.parallel.multihost import init_distributed\n"
            "try:\n"
            f"    init_distributed('127.0.0.1:{port}', 2, 1, initialization_timeout=1, backend='gloo')\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "else:\n"
            "    print('NO_ERROR')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True, timeout=60)
    assert "RAISED" in out.stdout and "NO_ERROR" not in out.stdout, (out.stdout, out.stderr[-2000:])


# -- (c) one dp-2 step in two ranks ----------------------------------------------------


def _jax_models():
    return {"nafnet": jm.EnhancedNAFNet(TINY_NAF), "expert": jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=8)),
            "diffusion": jm.UNetDiffusion(TINY_UNET)}


def _jax_variables(name, jmodel, rng):
    x = jnp.zeros((1, SIZE, SIZE, 1))
    args = (x, x, jnp.zeros((1,), jnp.int32)) if name == "diffusion" else (x,)
    return perturb(jax_init(jmodel, *args, seed=3), rng)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The inputs, the two ranks' results and the single-process ``.pth``
    that the ranks resumed."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    job = {"batch": BATCH, "weight_decay": WD}
    inputs = {}
    for name, jmodel in _jax_models().items():
        variables = _jax_variables(name, jmodel, rng)
        clean = image(rng, BATCH, SIZE, SIZE, 1)
        noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
        inputs[name] = (jmodel, variables, clean, noisy)
        job[name] = {"state": state_dict_from_jax(variables), "clean": nchw(clean), "noisy": nchw(noisy)}
    # the JAX dp step's draws for the global batch (trainer.py:203-206)
    jsched = jmake_schedule(jcfg.SERVE_SCHEDULE)
    k_t, k_eps = jax.random.split(jax.random.PRNGKey(5))
    clean = inputs["diffusion"][2]
    t = jsample_timesteps(k_t, BATCH, jsched.noise_steps)
    x_t, eps = jnoise_images(jnp.asarray(clean), t, jsched, k_eps)
    job["diffusion"]["draw"] = (torch.from_numpy(np.array(t)).long(), nchw(np.array(x_t)), nchw(np.array(eps)))
    nan_clean = job["nafnet"]["clean"].clone()
    nan_clean[BATCH - 1, 0, 3, 5] = float("nan")  # in rank 1's rows only
    job["nonfinite"] = {"clean": nan_clean}
    single = worker._trainer("expert", job, str(tmp / "single"), mesh_shape=None)
    single.train_step((job["expert"]["clean"], job["expert"]["noisy"]))
    single.state.epoch, single.state.best_psnr, single.state.best_ssim = 3, 24.0, 0.75
    single.state.history = {"losses": [0.5, 0.25, 0.125, 0.0625], "psnrs": [20.0, 22.0, 23.0, 24.0],
                            "ssims": [0.5, 0.6, 0.7, 0.75]}
    job["resume_path"] = single.save()
    torch.save(job, tmp / "job.pt")
    store = tmp / "store"
    _run([[sys.executable, WORKER, str(store), str(r), "2", str(tmp / "job.pt"), str(tmp)] for r in range(2)])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return job, inputs, ranks, jsched


def _single_step(name, job):
    """The port's single-process step on the global batch: (loss, state, grads)."""
    trainer = worker._trainer(name, job, "unused", job[name].get("draw"), mesh_shape=None)
    loss = trainer.train_step((job[name]["clean"], job[name]["noisy"]))
    return worker._record(trainer, loss)


def _jax_dp_step(name, jmodel, variables, clean, noisy, jsched):
    """The JAX package's step over a dp-2 mesh: (loss, state_dict)."""
    cfg = jtrainer.TrainConfig(epochs=1, batch_size=BATCH, lr=LR, weight_decay=WD, mesh_shape=(2, 1, 1))
    batch = (jnp.asarray(clean), jnp.asarray(noisy))
    key = jax.random.PRNGKey(5)
    params, stats = variables["params"], None
    if name == "nafnet":
        mesh = jmake_mesh(2, tp=1)
        with mesh:
            step, p, opt = jsharded_step(jtrainer.nafnet_loss_fn(jmodel), jtrainer.make_optimizer(cfg), params, mesh)
            new, _, loss = step(p, opt, batch, key)
    elif name == "expert":
        jt = jtrainer.Trainer(jtrainer.expert_loss_fn(jmodel), lambda *a: None, cfg, params,
                              extra={"batch_stats": variables["batch_stats"]}, has_batch_stats=True)
        new, _, stats, loss = jt._train_step(jt.state.params, jt.state.opt_state, variables["batch_stats"], batch, key)
    else:
        jt = jtrainer.Trainer(jtrainer.diffusion_loss_fn(jmodel, jsched), lambda *a: None, cfg, params)
        new, _, loss = jt._train_step(jt.state.params, jt.state.opt_state, batch, key)
    tree = {"params": jax.tree_util.tree_map(np.asarray, new)}
    if stats is not None:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray, stats)
    return {"loss": float(loss), "state": state_dict_from_jax(tree)}


@pytest.mark.parametrize("name", ["nafnet", "expert", "diffusion"])
def test_dp_step_matches_the_jax_dp_step_and_the_single_process_step(dp_run, name):
    job, inputs, ranks, jsched = dp_run
    assert ranks[0][name]["rows"] == (0, 2) and ranks[1][name]["rows"] == (2, 2)
    assert ranks[0][name]["loss"] == ranks[1][name]["loss"]
    for k, v in ranks[0][name]["state"].items():  # the replicas stay equal
        assert torch.equal(v, ranks[1][name]["state"][k]), k
    got, single = ranks[0][name], _single_step(name, job)
    assert_step_matches(got, single, f"{name} vs the port in one process", single["grads"], LR)
    assert_step_matches(got, _jax_dp_step(name, *inputs[name], jsched), f"{name} vs JAX dp 2", single["grads"], LR)


def test_a_nan_in_one_ranks_rows_is_skipped_on_both(dp_run):
    job, _, ranks, _ = dp_run
    for r in ranks:
        assert np.isnan(r["nonfinite"]["loss"]) and r["nonfinite"]["optimizer_state"] == 0
        for k, v in job["nafnet"]["state"].items():
            assert torch.equal(r["nonfinite"]["state"][k], v), k


def test_a_dp2_checkpoint_resumes_in_one_process(dp_run, tmp_path):
    job, _, ranks, _ = dp_run
    saved = ranks[0]["saved"]
    trainer = worker._trainer("expert", job, str(tmp_path), mesh_shape=None)
    trainer.resume(saved["path"])
    st = trainer.state
    for k, v in ranks[0]["expert"]["state"].items():  # weights and BatchNorm buffers
        assert torch.equal(st.model.state_dict()[k], v), k
    _assert_optimizer_equal(st.optimizer.state_dict(), saved["optimizer"])
    assert (st.epoch, st.best_psnr, st.best_ssim) == (1, 21.5, 0.5)
    assert st.history["losses"] == [ranks[0]["expert"]["loss"]]
    assert np.isfinite(trainer.train_step((job["expert"]["clean"], job["expert"]["noisy"])))


def test_a_single_process_checkpoint_resumes_at_dp2(dp_run):
    job, _, ranks, _ = dp_run
    ckpt = torch.load(job["resume_path"], weights_only=True)
    for r in ranks:
        res = r["resumed"]
        for k, v in ckpt["model_state_dict"].items():
            assert torch.equal(res["state"][k], v), k
        _assert_optimizer_equal(res["optimizer"], ckpt["optimizer_state_dict"])
        assert res["epoch"] == ckpt["epoch"] + 1 == 4 and res["best"] == (24.0, 0.75)
        assert res["history"]["losses"] == ckpt["losses"]
    assert ranks[0]["resumed"]["next_loss"] == ranks[1]["resumed"]["next_loss"]


def _assert_optimizer_equal(got, want):
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


# -- (d) the CLI under torchrun ------------------------------------------------------------


def _write_pairs(root, n=8):
    rng = np.random.default_rng(21)
    dirs = [root / "clean", root / "noisy"]
    for d in dirs:
        d.mkdir()
    for i in range(n):
        a = (rng.random((20, 20)) * 255).astype(np.uint8)
        Image.fromarray(a).save(dirs[0] / f"img{i}.png")
        Image.fromarray(255 - a).save(dirs[1] / f"img{i}.png")
    return [str(d) for d in dirs]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each recipe at dp 2 under torchrun (and a single-process diffusion
    ``.pth`` resumed there), after the diffusion, NAFNet and expert recipes
    ran in this process on the same data."""
    tmp = tmp_path_factory.mktemp("cli")
    dirs = _write_pairs(tmp)
    single = {}
    cwd = os.getcwd()
    for model in worker.CLI_COMPARED:
        (tmp / "single" / model).mkdir(parents=True)
        os.chdir(tmp / "single" / model)
        try:
            single[model] = trecipes.main(worker.cli_argv(model, *dirs))
        finally:
            os.chdir(cwd)
    out = _run([[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                 WORKER, "cli", str(tmp), *dirs]], cwd=str(tmp))[0]
    return tmp, dirs, single, out


@pytest.mark.parametrize("model", trecipes.MODELS)
def test_every_recipe_trains_at_dp2_under_torchrun(cli_runs, model):
    tmp, _, _, out = cli_runs
    ckpt = torch.load(tmp / "dp" / model / "checkpoints" / f"{model}.pth", weights_only=True)
    assert ckpt["epoch"] == 0 and all(np.isfinite(ckpt["losses"])), ckpt["losses"]
    assert "backend gloo" in out


@pytest.mark.parametrize("model", worker.CLI_COMPARED)
def test_the_dp2_cli_matches_the_cli_in_one_process(cli_runs, model):
    """The same global batches, in the same order with the same
    augmentation draws, and the same step draws: after one epoch of two to
    four steps, the epoch's loss to 1e-5, the BatchNorm buffers to 1e-4,
    and the weights to 2 lr x steps (Adam's sign-like early steps move
    entries whose gradient is rounding noise anywhere in +-lr, on each
    side)."""
    tmp, _, single, _ = cli_runs
    dp = torch.load(tmp / "dp" / model / "checkpoints" / f"{model}.pth", weights_only=True)
    one = torch.load(tmp / "single" / model / "checkpoints" / f"{model}.pth", weights_only=True)
    np.testing.assert_allclose(dp["losses"], one["losses"], rtol=1e-5)
    steps = int(dp["optimizer_state_dict"]["state"][0]["step"])
    assert steps == int(one["optimizer_state_dict"]["state"][0]["step"]) >= 2
    lr = trecipes.default_train_config(model).lr
    for k, v in one["model_state_dict"].items():
        diff = (dp["model_state_dict"][k].double() - v.double()).abs().max().item()
        assert diff <= 2 * lr * steps, (k, diff)
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(dp["model_state_dict"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4 * v.abs().max().item(), err_msg=k)


def test_resume_across_world_sizes_through_the_cli(cli_runs, monkeypatch):
    """The dp-2 diffusion ``.pth`` resumes for one more epoch in one
    process, from exactly its state; the ranks resumed the single-process
    one and checked it the same way (the worker asserts it)."""
    tmp, dirs, _, out = cli_runs
    assert out.count("resumed the single-process diffusion.pth") == 2
    path = tmp / "dp" / "diffusion" / "checkpoints" / "diffusion.pth"
    ckpt = torch.load(path, weights_only=True)
    restored = []
    orig = ttrainer.Trainer.resume

    def resume(self, p):
        orig(self, p)
        restored.append(worker.restored_matches(self, p))

    monkeypatch.setattr(ttrainer.Trainer, "resume", resume)
    (tmp / "resume1").mkdir()
    monkeypatch.chdir(tmp / "resume1")
    st = trecipes.main(worker.cli_argv("diffusion", *dirs, epochs=2) + ["--resume", str(path)])
    assert restored == [True]
    assert st.history["losses"][:1] == ckpt["losses"] and len(st.history["losses"]) == 2


@pytest.mark.parametrize("mesh", ["1,2,2"])
def test_sp_and_tp_are_refused_naming_the_roadmap_item(tmp_path, mesh):
    """Training at sp > 1 and tp > 1 together is ported
    (tests/test_torch_sp_tp_train.py): the mesh check takes the shape, and
    in one process the CLI and the trainer refuse it only for its missing
    ranks, as they refuse any mesh whose ranks do not run."""
    shape = tuple(int(x) for x in mesh.split(","))
    missing = r"mesh_shape \(1, 2, 2\) needs 4 devices, have 1"
    dirs = _write_pairs(tmp_path, n=2)
    with pytest.raises(ValueError, match=missing):
        trecipes.main(worker.cli_argv("nafnet", *dirs) + ["--mesh", mesh])
    cfg = ttrainer.TrainConfig(mesh_shape=shape)
    with pytest.raises(ValueError, match=missing):
        ttrainer.Trainer(lambda *a: None, lambda *a: None, cfg, torch.nn.Linear(2, 2), ttrainer.no_draw, device="cpu")
    assert tmesh.check_mesh_shape(mesh.split(",")) == shape


def test_a_mesh_needs_its_ranks():
    m = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 1, 1\) needs 2 devices, have 1"):
        ttrainer.Trainer(None, None, ttrainer.TrainConfig(mesh_shape=(2, 1, 1)), m, ttrainer.no_draw, device="cpu")
    trainer = ttrainer.Trainer(None, None, ttrainer.TrainConfig(mesh_shape=(1, 1, 1)), m, ttrainer.no_draw,
                               device="cpu")
    assert trainer.mesh is None and trainer.rows is None  # one rank: the single-process step


@pytest.mark.parametrize("workers", [0, 2])
def test_a_ranks_rows_are_the_single_process_batches_rows(workers):
    """Rank r of 2 builds rows [2r, 2r + 2) of each batch of 4, each item
    with the augmentation draw it gets in one process, and the same on a
    thread pool as without."""
    from midd_tpu_torch.train import data as tdata

    clean = np.random.default_rng(3).random((9, 12, 12, 1)).astype(np.float32)
    whole = list(tdata.batches(tdata.SyntheticPairedDataset(clean, seed=4), 4, seed=6))
    assert len(whole) == 2  # the ragged ninth item dropped
    for rank in range(2):
        ds = tdata.SyntheticPairedDataset(clean, seed=4)
        part = list(tdata.batches(ds, 4, seed=6, num_workers=workers, rows=tmulti.process_batch_slice(4, 2, rank)))
        for (c, n), (wc, wn) in zip(part, whole, strict=True):
            np.testing.assert_array_equal(c, wc[2 * rank : 2 * rank + 2])
            np.testing.assert_array_equal(n, wn[2 * rank : 2 * rank + 2])
