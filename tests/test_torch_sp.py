"""Spatial parallelism in the port (``parallel/sp.py``): the engine's
``spatial_parallel`` and ``sp_size`` against the JAX engine's sp modes, and
the trainer at ``mesh_shape = (dp, sp, 1)`` against single-process autograd,
the port's one-process step and the JAX trainer over the same mesh, on the
conftest's 8 virtual CPU devices at the tiny widths of
``tests/test_sharding.py:233-249`` (the port's engine is given
``["cpu"] * n``).

JAX's sp composed with tp gives wrong results on XLA's CPU partitioner
(NAFNet and hybrid paths 0.46-0.72 away from the unsharded engine at
(sp 2, tp 2); ROADMAP.md, "Read port results against these"), so the
port's sp × tp engine is held to the unsharded JAX engine; sp alone is held
to the JAX sp engine. Every port engine is also held to the port's
unsharded one.

Two torchrun launches over gloo (``tests/_torch_sp_worker.py``), started
together with the JAX steps by one module fixture: 2 ranks (layers at sp 2,
the (1, 2, 1) step, the CLI at ``--mesh 1,2,1``, resumes at (1, 2, 1) and
(1, 1, 2)) and 4 ranks (the (2, 2, 1) checkpoint and its resume at
(4, 1, 1), layers at sp 3, the (2, 2, 1) step).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.serve import server as jserver
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.ops.qconv import QuantConv2d
from midd_tpu_torch.parallel import RowParallel, row_blocks, shard_rows
from midd_tpu_torch.parallel.mesh import check_mesh_shape
from midd_tpu_torch.serve import server as tserver
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from tests import _torch_dp_worker as dpw
from tests import _torch_sp_worker as worker
from tests import _torch_tp_worker as tpw
from tests.test_torch_parallel import _env, _write_pairs
from tests.test_torch_serve import _small
from tests.test_torch_tp_serve import INT8_VS_UNSHARDED, _assert_int8_close, ckpt_dir  # noqa: F401
from tests.test_torch_tp_train import BATCH, FP64_BOUND, NORM_REL, RESUME_RTOL, SIZE, TINY_NAF, _jax_step, _unsharded
from tests.torch_port_util import assert_step_matches, image, jax_init, nchw, perturb, rand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sp_worker.py")
ATOL = 1e-5  # fp32, tests/test_sharding.py:262
EXACT = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
CPU8 = ["cpu"] * 8
LAUNCH_TIMEOUT_S = 300
MESHES = [(1, 2, 1), (2, 2, 1)]

# -- (1) the engine's row split, in one process ----------------------------------


def _chain(sp: int) -> tuple:
    torch.manual_seed(sp)
    return worker.Chain().double().eval(), torch.randn(2, 2, 13, 10, dtype=torch.float64)


def test_row_blocks_are_tensor_splits():
    for h in (1, 3, 7, 13, 64):
        for sp in (1, 2, 3, 4):
            want = [len(t) for t in torch.arange(h).tensor_split(sp)]
            assert [b - a for a, b in row_blocks(h, sp)] == want
            assert row_blocks(h, sp)[-1][1] == h


@pytest.mark.parametrize("sp", [2, 3])
def test_row_parallel_layers_match_the_whole_ones(sp):
    """Every convolution kind split over ``["cpu"] * sp`` on an odd height
    (uneven blocks) in fp64: 1e-12 of the output's scale; a dynamic int8
    module in fp32 equal bit for bit (the whole input's scale, exact int8
    products); gradients on raise."""
    model, x = _chain(sp)
    with torch.no_grad():
        want = model(x)
        assert shard_rows(model, ["cpu"] * sp) == 8
        got = model(x)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= FP64_BOUND * max(1.0, w.abs().max().item())
    assert isinstance(model.updown, RowParallel) and not isinstance(model.lin, RowParallel)
    with pytest.raises(RuntimeError, match="shard_rows_over_group"):
        model(x)
    torch.manual_seed(3)
    quant, xq = worker.Quant(), torch.randn(2, 3, 13, 9)
    with torch.no_grad():
        want = quant(xq)
        shard_rows(quant, ["cpu"] * sp)
        assert isinstance(quant.a.blocks[0], QuantConv2d)
        assert torch.equal(quant(xq), want)


def test_sca_and_linears_stay_whole():
    naf = EnhancedNAFNet(tcfg.NAFNetConfig(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)))
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in naf.modules())
    n_sca = sum(1 for n, _ in naf.named_modules() if n.endswith("sca.1"))
    assert shard_rows(naf, ["cpu"] * 2) == n_conv - n_sca > 0
    assert all(not isinstance(m, RowParallel) for n, m in naf.named_modules() if ".sca" in n)
    with pytest.raises(ValueError, match="already"):
        shard_rows(naf, ["cpu"] * 2)


# -- (2)-(4) engines ---------------------------------------------------------------

_FLAGS = {
    "sp": dict(spatial_parallel=True),
    "dp+sp": dict(spatial_parallel=True, data_parallel=True, sp_size=4),
    "sp+tp": dict(spatial_parallel=True, tensor_parallel=True, sp_size=2, tp_size=2, tp_min_size=64),
}
WANT_MESH = {"sp": {"dp": 1, "sp": 4, "tp": 1}, "dp+sp": {"dp": 2, "sp": 4, "tp": 1},
             "sp+tp": {"dp": 1, "sp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def jax_engines(ckpt_dir):  # noqa: F811
    """The JAX engine of each flag set ("plain": unsharded), built on first use."""
    built = {}

    def get(flags: str):
        if flags not in built:
            built[flags] = JEngine(JEngineConfig(**_small(jcfg), **EXACT, **_FLAGS.get(flags, {}),
                                                 ckpt_dir=ckpt_dir, persistent_cache=False))
        return built[flags]

    return get


def _port(ckpt_dir, devices=CPU8, **kw):  # noqa: F811
    return InferenceEngine(EngineConfig(**_small(tcfg), **EXACT, ckpt_dir=ckpt_dir, device="cpu", **kw),
                           devices=devices)


@pytest.mark.parametrize("flags", list(_FLAGS))
def test_mesh_shape_and_count_match_the_jax_engine(jax_engines, ckpt_dir, flags):  # noqa: F811
    jeng = jax_engines(flags)
    teng = _port(ckpt_dir, **_FLAGS[flags])
    try:
        assert teng.mesh_shape == dict(jeng.mesh.shape) == WANT_MESH[flags]
        assert teng.n_tp_sharded == jeng.n_tp_sharded
        assert (teng.n_tp_sharded > 0) == (flags == "sp+tp")
    finally:
        teng.close()


@pytest.mark.parametrize("flags", list(_FLAGS))
def test_sp_engine_matches_jax_and_the_unsharded_engines(jax_engines, ckpt_dir, flags):  # noqa: F811
    """Every path, batch 1 and 2 (dp 2: batch 2), fp32, 1e-5: against the
    JAX engine of the same flags where tp is 1, else the unsharded JAX
    engine (JAX's sp × tp is wrong on the CPU), and the port's unsharded
    engine in every case."""
    jeng = jax_engines("plain" if "tp" in flags else flags)
    teng, plain = _port(ckpt_dir, **_FLAGS[flags]), _port(ckpt_dir)
    try:
        unet = teng.replicas[0]["unet_eval"]
        assert any(isinstance(m, RowParallel) for m in unet.modules())
        for batch in (2,) if "dp" in flags else (1, 2):
            x = image(np.random.default_rng(30 + batch), batch, 16, 16, 1)
            for name in MODEL_NAMES:
                got = teng.fns[name](x)
                np.testing.assert_allclose(got, np.asarray(jeng.fns[name](jnp.asarray(x))), atol=ATOL,
                                           err_msg=f"{flags} {name} b{batch} vs JAX")
                np.testing.assert_allclose(got, plain.fns[name](x), atol=ATOL,
                                           err_msg=f"{flags} {name} b{batch} vs unsharded")
    finally:
        teng.close()
        plain.close()


def _tiny_demo(**kw):
    return EngineConfig(**_small(tcfg), **EXACT, ckpt_dir="/nonexistent", device="cpu", **kw)


def test_fused_and_turbo_paths_split_over_sp():
    flags = dict(fused_request=True, adaptive_turbo=True)
    plain = InferenceEngine(_tiny_demo(**flags))
    eng = InferenceEngine(_tiny_demo(**flags, spatial_parallel=True, sp_size=2), devices=["cpu"] * 2)
    try:
        assert eng.mesh_shape == {"dp": 1, "sp": 2, "tp": 1}
        x = image(np.random.default_rng(11), 1, 16, 16, 1)
        got, want = eng.fused(x), plain.fused(x)
        for name in MODEL_NAMES:
            np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)
        for name in eng.turbo_fns:
            np.testing.assert_allclose(eng.turbo_fns[name](x), plain.turbo_fns[name](x), atol=ATOL, err_msg=name)
        assert eng.serving_mode() == plain.serving_mode()
    finally:
        eng.close()
        plain.close()


def test_bf16_engine_under_sp():
    kw = dict(**_small(tcfg), ckpt_dir="/nonexistent", device="cpu")
    plain = InferenceEngine(EngineConfig(**kw))
    eng = InferenceEngine(EngineConfig(**kw, spatial_parallel=True, sp_size=2), devices=["cpu"] * 2)
    try:
        blocks = [b for m in eng.replicas[0]["unet_eval"].modules() if isinstance(m, RowParallel)
                  for b in m.blocks if type(b).__name__ == "Conv2d"]
        assert blocks and all(b.weight.dtype == torch.bfloat16 for b in blocks)
        x = image(np.random.default_rng(7), 1, 16, 16, 1)
        for name in MODEL_NAMES:
            np.testing.assert_allclose(eng.fns[name](x), plain.fns[name](x), atol=2.0 ** -7, err_msg=name)
    finally:
        eng.close()
        plain.close()


@pytest.mark.parametrize("int8", ["static", True])
def test_int8_engine_under_sp_matches_the_unsharded_int8_engine(int8):
    """Calibrated whole, then split: a static block keeps the layer's scale
    on its device; a dynamic block quantises with the whole input's. The
    int8 products of a block are exact, so the static rollouts stay within
    1e-4 of the unsharded int8 engine's; dynamic scales move with the fp32
    layers' sums, within the int8 bounds of tests/test_torch_qconv.py."""
    plain = InferenceEngine(_tiny_demo(quantize_int8=int8))
    eng = InferenceEngine(_tiny_demo(quantize_int8=int8, spatial_parallel=True, sp_size=2), devices=["cpu"] * 2)
    try:
        blocks = [b for key in ("unet_eval", "hyb_unet_eval") for m in eng.replicas[0][key].modules()
                  if isinstance(m, RowParallel) for b in m.blocks if isinstance(b, QuantConv2d)]
        assert blocks and all(b.mode == ("static" if int8 == "static" else "dynamic") for b in blocks)
        assert all((b.act_absmax is not None) == (int8 == "static") for b in blocks)
        if int8 == "static":
            for name, scale in plain.int8_scales["diffusion"].items():
                torch.testing.assert_close(eng.int8_scales["diffusion"][name], scale, rtol=0, atol=0)
        x = image(np.random.default_rng(12), 2, 16, 16, 1)
        for name in MODEL_NAMES:
            got, want = eng.fns[name](x), plain.fns[name](x)
            if name in ("nafnet", "expert") or int8 == "static":
                np.testing.assert_allclose(got, want, atol=INT8_VS_UNSHARDED if int8 == "static" else ATOL,
                                           err_msg=name)
            else:
                _assert_int8_close(got, want, name)
    finally:
        eng.close()
        plain.close()


def _deep_nafnet_ckpt(tmp_path) -> str:
    """A nafnet.pth whose metadata deepens the NAFNet to 3 encoder stages
    (16² -> 2 rows at the deepest map, where the preset reaches 4)."""
    cfg = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1, 1), dec_blk_nums=(1, 1, 1))
    variables = jax_init(jm.EnhancedNAFNet(jcfg.NAFNetConfig(**cfg)), jnp.zeros((1, 16, 16, 1)), seed=5)
    torch.save({"model_state_dict": state_dict_from_jax(variables), "epoch": 1, **cfg}, tmp_path / "nafnet.pth")
    return str(tmp_path)


def _raised(build) -> str:
    with pytest.raises(ValueError, match="deepest") as info:
        build()
    return str(info.value)


def test_sp_past_the_deepest_map_raises_the_jax_message(tmp_path):
    kw = dict(**_small(jcfg), **EXACT, ckpt_dir="/nonexistent", persistent_cache=False)
    want = _raised(lambda: JEngine(JEngineConfig(**kw, spatial_parallel=True, sp_size=8)))
    assert want == _raised(lambda: InferenceEngine(_tiny_demo(spatial_parallel=True, sp_size=8), devices=CPU8))
    deep = _deep_nafnet_ckpt(tmp_path)
    want = _raised(lambda: JEngine(JEngineConfig(**{**kw, "ckpt_dir": deep}, spatial_parallel=True, sp_size=4)))
    assert "height 2 " in want
    cfg = dict(**_small(tcfg), **EXACT, ckpt_dir=deep, device="cpu")
    assert want == _raised(lambda: InferenceEngine(EngineConfig(**cfg, spatial_parallel=True, sp_size=4),
                                                   devices=CPU8))
    eng = InferenceEngine(EngineConfig(**cfg, spatial_parallel=True), devices=CPU8)
    try:
        assert eng.mesh_shape == {"dp": 1, "sp": 2, "tp": 1}  # auto: capped at the checkpoint's depth
    finally:
        eng.close()


@pytest.mark.parametrize("argv", [[], ["--sp", "2"], ["--sp", "-1"], ["--sp", "4", "--tp", "--dp"]])
def test_server_sp_flag_maps_as_the_jax_server(monkeypatch, argv):
    """The JAX server's command line (its ``__main__`` block, run with
    ``serve_forever`` caught) against the port's ``config_from_args``."""
    seen = {}
    src = open(jserver.__file__).read()
    main = src[src.index('if __name__ == "__main__":'):]
    namespace = {**vars(jserver), "__name__": "__main__",
                 "serve_forever": lambda host, port, engine_config: seen.update(cfg=engine_config)}
    monkeypatch.setattr(sys, "argv", ["server", *argv])
    exec(compile(main, jserver.__file__, "exec"), namespace)
    _, cfg = tserver.config_from_args(argv)
    fields = ("spatial_parallel", "sp_size", "tensor_parallel", "data_parallel")
    assert [getattr(cfg, f) for f in fields] == [getattr(seen["cfg"], f) for f in fields]


def test_process_one_answers_one_path():
    eng = InferenceEngine(_tiny_demo(spatial_parallel=True, sp_size=2), devices=["cpu"] * 2)
    try:
        x = image(np.random.default_rng(13), 1, 16, 16, 1)
        assert eng.process_one("nafnet", x, (16, 16)) == eng.process_all(x, (16, 16))["nafnet"]
    finally:
        eng.close()


# -- (5), (6) training over ranks -------------------------------------------------


def _launch(n: int, args: list, cwd: str):
    import subprocess

    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                             str(n), WORKER, *args], env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module", autouse=True)
def launches(tmp_path_factory):
    """The two torchrun launches, started before the module's first test so
    that they run beside the engine tests; with the job and the JAX model
    they were given."""
    tmp = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(12)
    jmodel = jm.EnhancedNAFNet(TINY_NAF)
    variables = perturb(jax_init(jmodel, jnp.zeros((1, SIZE, SIZE, 1)), seed=3), rng)
    clean = image(rng, BATCH, SIZE, SIZE, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
    job = {"batch": BATCH, "weight_decay": 1e-4,
           "nafnet": {"state": state_dict_from_jax(variables), "clean": nchw(clean), "noisy": nchw(noisy)},
           "dataset": rng.random((8, SIZE, SIZE, 1)).astype(np.float32)}
    torch.save(job, tmp / "job.pt")
    dirs = _write_pairs(tmp)
    procs = {"sp4": _launch(4, ["sp4", str(tmp / "job.pt"), str(tmp)], str(tmp)),
             "sp2": _launch(2, ["sp2", str(tmp / "job.pt"), str(tmp), *dirs], str(tmp))}
    try:
        yield {"tmp": tmp, "job": job, "procs": procs, "jax": (jmodel, variables, clean, noisy)}
    finally:
        for p in procs.values():
            p.kill()


@pytest.fixture(scope="module")
def sp_runs(launches):
    """Both launches' per-rank records, the JAX steps and the port's
    one-process step (with its clip norm)."""
    tmp, job, procs = launches["tmp"], launches["job"], launches["procs"]
    jmodel, variables, clean, noisy = launches["jax"]
    try:
        jax_steps = {m: _jax_step(m, jmodel, variables, clean, noisy) for m in MESHES}
        single = tpw._trainer(job, None, str(tmp / "unused"))
        with tpw.recorded_norms() as norms:
            loss = single.train_step((job["nafnet"]["clean"], job["nafnet"]["noisy"]))
        single = {**dpw._record(single, loss), "norm": norms[-1]}
        outs = {k: p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, outs[k][-6000:]
    ranks = {k: [torch.load(tmp / f"{k}.rank{r}.pt", weights_only=False) for r in range(n)]
             for k, n in (("sp2", 2), ("sp4", 4))}
    return {"tmp": tmp, "job": job, "ranks": ranks, "jax": jax_steps, "single": single, "out": outs}


@pytest.mark.parametrize("launch, sp", [("sp2", 2), ("sp4", 3)])
def test_row_split_layers_match_single_process_autograd_in_fp64(sp_runs, launch, sp):
    ranks = [r["layers"] for r in sp_runs["ranks"][launch][:sp]]
    for got in ranks:
        chain = got["chain"]
        assert len(chain["summed"]) == 16, chain["summed"]  # 8 convolutions' weights and biases; not lin's
        assert chain["out"] <= FP64_BOUND and chain["dx"] <= FP64_BOUND, (chain["out"], chain["dx"])
        worst = max(chain["grads"], key=chain["grads"].get)
        assert chain["grads"][worst] <= FP64_BOUND, (worst, chain["grads"][worst])
        assert got["quant"]["equal"] and got["quant"]["no_grad_equal"], got["quant"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: ",".join(map(str, m)))
def test_sp_step_matches_the_jax_trainer_and_the_one_process_step(sp_runs, mesh):
    ranks = [r["step"] for r in sp_runs["ranks"]["sp2" if mesh[0] == 1 else "sp4"]]
    if mesh[0] == 1:
        assert [r["image_sharding"] for r in ranks] == [(0, 4, 0, 2), (0, 4, 1, 2)]
    else:
        assert [r["image_sharding"] for r in ranks] == [(0, 2, 0, 2), (0, 2, 1, 2), (2, 2, 0, 2), (2, 2, 1, 2)]
    for r in ranks[1:]:  # every rank holds the same loss and the same whole weights
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
    got, single, want = ranks[0], sp_runs["single"], sp_runs["jax"][mesh]
    assert got["summed"] > 0 and set(got["state"]) == set(single["state"])
    assert_step_matches(got, single, f"sp {mesh} vs the port in one process", single["grads"], 1e-3)
    assert_step_matches(got, want, f"sp {mesh} vs the JAX trainer", single["grads"], 1e-3)


def test_whole_parameters_stay_equal_on_the_sp_ranks(sp_runs):
    a, b = (r["drift"] for r in sp_runs["ranks"]["sp2"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: ",".join(map(str, m)))
def test_clip_norm_at_sp_is_the_whole_gradients(sp_runs, mesh):
    want = sp_runs["single"]["norm"]
    for r in sp_runs["ranks"]["sp2" if mesh[0] == 1 else "sp4"]:
        assert r["step"]["norm"] == pytest.approx(want, rel=NORM_REL), (r["step"]["norm"], want)


@pytest.fixture(scope="module")
def one_process_resume(sp_runs):
    job = sp_runs["job"]
    path = sp_runs["ranks"]["sp4"][0]["resume_src"]["path"]
    tr = tpw._trainer(job, None, str(sp_runs["tmp"] / "one_resumed"), epochs=2, batch=8)
    tr.resume(path)
    matches, epoch = dpw.restored_matches(tr, path), tr.state.epoch
    ds = worker._dataset(job)
    tr.fit(ds, [ds[0]], verbose=False)
    return matches, epoch, tr.state.history["losses"]


@pytest.mark.parametrize("target", ["4,1,1", "1,2,1", "1,1,2", "one process"])
def test_a_dp2_sp2_checkpoint_resumes_exactly_at_any_mesh(sp_runs, one_process_resume, target):
    src = sp_runs["ranks"]["sp4"][0]["resume_src"]
    ckpt = torch.load(src["path"], weights_only=True)
    assert list(ckpt["model_state_dict"]) == list(EnhancedNAFNet(trecipes.TINY_NAFNET).state_dict())
    _, _, want = one_process_resume
    if target == "one process":
        runs = [one_process_resume]
    else:
        key = tuple(int(x) for x in target.split(","))
        launch = "sp4" if key == (4, 1, 1) else "sp2"
        runs = [(r["resume"][key]["matches"], r["resume"][key]["epoch"], r["resume"][key]["losses"])
                for r in sp_runs["ranks"][launch]]
    for matches, epoch, losses in runs:
        assert matches and epoch == 1
        assert losses[0] == src["src_losses"][0] and len(losses) == 2
        np.testing.assert_allclose(losses, want, rtol=RESUME_RTOL, err_msg=target)


@pytest.mark.parametrize("model", worker.CLI_MODELS)
def test_every_recipe_trains_at_sp2_under_torchrun(sp_runs, model):
    ranks = sp_runs["ranks"]["sp2"]
    assert ranks[0]["cli"][model] == ranks[1]["cli"][model] > 0
    ckpt = torch.load(sp_runs["tmp"] / "cli" / model / "checkpoints" / f"{model}.pth", weights_only=True)
    assert ckpt["epoch"] == 0 and all(np.isfinite(ckpt["losses"])), ckpt["losses"]
    unsharded = _unsharded(model)
    unsharded.load_state_dict(ckpt["model_state_dict"], strict=True)
    opt = ckpt["optimizer_state_dict"]
    shapes = [p.shape for p in unsharded.parameters()]
    assert opt["param_groups"][0]["params"] == list(range(len(shapes)))
    assert [opt["state"][i]["exp_avg"].shape for i in range(len(shapes))] == shapes
    assert "backend gloo" in sp_runs["out"]["sp2"]


def test_trainer_refuses_sp_with_tp_naming_item_15d():
    """sp with tp is ported (tests/test_torch_sp_tp_train.py): the mesh
    check returns the shape, and in one process the trainer refuses (2, 2,
    2) only for its missing ranks."""
    assert check_mesh_shape((1, 2, 2)) == (1, 2, 2) and check_mesh_shape((2, 2, 2)) == (2, 2, 2)
    cfg = ttrainer.TrainConfig(mesh_shape=(2, 2, 2))
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 2, 2\) needs 8 devices, have 1"):
        ttrainer.Trainer(lambda *a: None, lambda *a: None, cfg, torch.nn.Linear(2, 2), ttrainer.no_draw,
                         device="cpu")
    assert check_mesh_shape((2, 2, 1)) == (2, 2, 1) and check_mesh_shape(("1", "4", "1")) == (1, 4, 1)
