"""Tensor- and data-parallel serving in the port's engine, against the JAX
engine's tp and dp modes on the CPU (8 devices: the JAX side fakes them,
``tests/conftest.py``; the port's engine is given ``["cpu"] * n``).

(1) The tp rule: the port's ``param_shardings`` splits the same parameters
    on the same output-channel axis as the JAX rule, leaf for leaf, at tiny
    widths with ``min_size`` 64 and at the full presets with the default.
(2) ``engine.mesh_shape`` equals the JAX engine's ``mesh.shape``.
(3), (4) The port's tp-8 and dp-8 engines equal the JAX tp and dp engines
    (``tests/test_sharding.py``) on one set of ``.pth`` files, fp32, 1e-5.
(5)-(11) No-ops on one device, dp's row rule, bf16 and ``sees_expert``
    engines under tp, the server's flags, static and dynamic int8 under tp
    against the JAX tp int8 engine and the port's unsharded int8 engine,
    ``serving_mode``.
"""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

import chip_smoke
from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.parallel import mesh as jmesh
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import _key
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import FusionModule, NoiseAnalyzer
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops import _build
from midd_tpu_torch.ops.qconv import QuantConv2d
from midd_tpu_torch.convert.from_jax import qscales_from_jax
from midd_tpu_torch.parallel import ColumnParallel, count_tp_sharded, param_shardings, shard_params
from midd_tpu_torch.parallel import tp as tp_module
from midd_tpu_torch.serve import engine as engine_module
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from tests.test_torch_serve import NAF, UNET, _nested_keys, _small
from tests.torch_port_util import image

ATOL = 1e-5  # fp32 on the CPU, as tests/test_sharding.py holds the JAX tp engine to its plain one
EXACT = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
CPU8 = ["cpu"] * 8

# -- (1) the tp rule, leaf for leaf ---------------------------------------------

# the torch dim that holds a JAX leaf's last axis (``convert/from_jax.py``)
TORCH_DIM = {"kernel": 0, "kernel_t": 1, "beta": 1, "gamma": 1}
TORCH_NAME = {"kernel": "weight", "kernel_t": "weight", "scale": "weight"}


def _models(size: str) -> dict:
    """name -> (JAX module, its init inputs, a function that makes the port module)."""
    x = jnp.zeros((1, 32, 32, 1))
    t = jnp.zeros((1,), jnp.int32)
    if size == "tiny":
        naf, unet = tcfg.NAFNetConfig(**NAF), tcfg.DiffusionUNetConfig(**UNET)
        jnaf, junet = jcfg.NAFNetConfig(**NAF), jcfg.DiffusionUNetConfig(**UNET)
        exp, router, fusion = 8, 8, 16
    else:
        naf, unet, jnaf, junet = tcfg.SERVE_NAFNET, tcfg.SERVE_DIFFUSION, jcfg.SERVE_NAFNET, jcfg.SERVE_DIFFUSION
        exp, router, fusion = tcfg.SERVE_EXPERT.base_channels, tcfg.RouterConfig().base_c, tcfg.FusionConfig().base_c
    return {
        "nafnet": (jm.EnhancedNAFNet(jnaf), (x,), lambda: EnhancedNAFNet(naf)),
        "unet": (jm.UNetDiffusion(junet), (x, x, t), lambda: UNetDiffusion(unet)),
        "expert": (jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=exp)), (x,),
                   lambda: ExpertDenoiser(tcfg.ExpertConfig(base_channels=exp))),
        "router": (jm.NoiseAnalyzer(jcfg.RouterConfig(base_c=router)), (x,),
                   lambda: NoiseAnalyzer(tcfg.RouterConfig(base_c=router))),
        "fusion": (jm.FusionModule(jcfg.FusionConfig(base_c=fusion)), (x, x, x),
                   lambda: FusionModule(tcfg.FusionConfig(base_c=fusion))),
        "model2_nafnet": (jm.EnhancedNAFNet(jcfg.MODEL2_NAFNET), (x,), lambda: EnhancedNAFNet(tcfg.MODEL2_NAFNET)),
    }


@functools.lru_cache(maxsize=None)
def _jax_shapes(size: str, name: str):
    model, args, _ = _models(size)[name]
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))["params"]


def _jax_rule(size: str, name: str, tp: int, min_size: int) -> tuple:
    """(JAX's ``count_tp_sharded``, its rule as port names -> split dim)."""
    shapes = _jax_shapes(size, name)
    shardings = jmesh.param_shardings(shapes, jmesh.make_mesh(8, tp=tp), min_size=min_size)
    rule = {}
    flat = jax.tree_util.tree_flatten_with_path(shardings, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
    for path, sharding in flat:
        keys = tuple(p.key for p in path)
        split = "tp" in jax.tree_util.tree_leaves(tuple(sharding.spec))
        rule[_key(keys[:-1], TORCH_NAME.get(keys[-1], keys[-1]))] = TORCH_DIM[keys[-1]] if split else None
    return jmesh.count_tp_sharded(shardings), rule


def _port_rule(size: str, name: str, tp: int, min_size: int) -> dict:
    with torch.device("meta"):
        module = _models(size)[name][2]()
    return param_shardings(module, tp, min_size)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("size,min_size", [("tiny", 64), ("full", 1 << 16)])
@pytest.mark.parametrize("name", ["nafnet", "unet", "expert", "router", "fusion", "model2_nafnet"])
def test_tp_rule_matches_jax_leaf_for_leaf(name, size, min_size, tp):
    want_count, want = _jax_rule(size, name, tp, min_size)
    got = _port_rule(size, name, tp, min_size)
    assert got == want
    assert count_tp_sharded(got) == want_count
    if size == "tiny" and name != "model2_nafnet":
        assert want_count > 0  # the tiny widths split real layers at min_size 64


def test_serve_presets_count_is_chip_smokes_constant():
    """The JAX engine's ``n_tp_sharded`` at tp 2 for the SERVE_* presets with
    demo weights (the standalone UNet, NAFNet and expert, and the hybrid's
    four groups), which ``chip_smoke.py`` phase 17 holds the card's engine
    to."""
    trees = ["unet", "nafnet", "expert", "router", "fusion", "nafnet", "unet"]
    assert sum(_jax_rule("full", n, 2, 1 << 16)[0] for n in trees) == chip_smoke.TP2_SERVE_SHARDED


# -- the port's tp layers ------------------------------------------------------


def test_shard_params_splits_in_channel_order():
    """Every split layer holds contiguous output-channel slices (SimpleGate
    halves its input, so an interleaved gather would pass at tp 1 only),
    the depthwise convs included; the count is the rule's."""
    torch.manual_seed(0)
    naf = init_weights(EnhancedNAFNet(tcfg.NAFNetConfig(**NAF)), torch.Generator().manual_seed(1)).eval()
    for blk in naf.modules():
        if hasattr(blk, "beta"):
            blk.beta.data.normal_()
            blk.gamma.data.normal_()
    x = torch.rand(2, 1, 16, 16)
    with torch.no_grad():
        want = naf(x)
    rule = param_shardings(naf, 4, 64)
    dw = naf.encoders[0][0].conv2.weight.clone()
    assert shard_params(naf, ["cpu"] * 4, 64) == count_tp_sharded(rule) > 0
    wrapped = [m for m in naf.modules() if isinstance(m, ColumnParallel)]
    assert len(wrapped) == sum(1 for k, d in rule.items() if d is not None and k.endswith("weight"))
    conv2 = naf.encoders[0][0].conv2
    assert isinstance(conv2, ColumnParallel) and [s.groups for s in conv2.shards] == [4] * 4
    torch.testing.assert_close(torch.cat([s.weight for s in conv2.shards]), dw, rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(naf(x), want, rtol=0, atol=ATOL)
    with pytest.raises(RuntimeError, match="shard_over_group"):
        naf(x)  # gradients on: the engine's form is inference only
    with pytest.raises(ValueError, match="already"):
        shard_params(naf, ["cpu"] * 4, 64)


def test_per_channel_parameters_split_where_the_rule_splits_them():
    """NAFBlock's beta and gamma are 4-D leaves in JAX: at a min_size below
    their channel count the rule splits them, so they are held as slices
    and gathered where they are read."""
    naf = init_weights(EnhancedNAFNet(tcfg.NAFNetConfig(**NAF)), torch.Generator().manual_seed(2)).eval()
    for blk in naf.modules():
        if hasattr(blk, "beta"):
            blk.beta.data.normal_()
    x = torch.rand(1, 1, 16, 16)
    with torch.no_grad():
        want = naf(x)
    rule = param_shardings(naf, 2, 16)
    assert rule["middle_blks.0.beta"] == 1 and rule["encoders.0.0.beta"] is None  # 32 and 8 channels
    shard_params(naf, ["cpu"] * 2, 16)
    beta = naf.middle_blks[0].parametrizations.beta
    assert beta.original0.shape == beta.original1.shape == (1, 16, 1, 1)
    with torch.no_grad():
        torch.testing.assert_close(naf(x), want, rtol=0, atol=ATOL)


# -- engines -------------------------------------------------------------------

_JAX_FLAGS = {
    "tp": dict(tensor_parallel=True, tp_min_size=64),
    "dp": dict(data_parallel=True),
    "dp+tp": dict(data_parallel=True, tensor_parallel=True),
    "tp_size 2": dict(tensor_parallel=True, tp_size=2),
}


def _seeded(module: torch.nn.Module, seed: int) -> dict:
    """A port model's state_dict with seeded weights and every bias, norm
    scale, NAFBlock beta/gamma and BatchNorm statistic random, so that none
    of them is a no-op."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    sd = module.state_dict()
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "beta", "gamma", "running_mean") or (leaf == "weight" and v.ndim == 1):
            v.copy_((1.0 if leaf == "weight" else 0.0) + 0.2 * torch.randn(v.shape, generator=gen))
        elif leaf == "running_var":
            v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    return sd


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """``.pth`` files of the four models at ``_small``'s widths, which both
    engines load."""
    path = tmp_path_factory.mktemp("tp_ckpts")
    naf, unet = tcfg.NAFNetConfig(**NAF), tcfg.DiffusionUNetConfig(**UNET)
    files = {"diffusion": _seeded(UNetDiffusion(unet), 1), "nafnet": _seeded(EnhancedNAFNet(naf), 2),
             "expert": _seeded(ExpertDenoiser(tcfg.ExpertConfig(base_channels=8)), 3), "hybrid": {}}
    for i, (prefix, module) in enumerate((("nafnet", EnhancedNAFNet(naf)), ("diffusion_unet", UNetDiffusion(unet)),
                                          ("router", NoiseAnalyzer(tcfg.RouterConfig(base_c=8))),
                                          ("fusion", FusionModule(tcfg.FusionConfig(base_c=16))))):
        files["hybrid"].update({f"{prefix}.{k}": v for k, v in _seeded(module, 10 + i).items()})
    for name, state in files.items():
        torch.save({"model_state_dict": state, "epoch": 1}, path / f"{name}.pth")
    return str(path)


@pytest.fixture(scope="module")
def jax_engines(ckpt_dir):
    """The JAX engine of each flag set, built on first use."""
    built = {}

    def get(flags: str):
        if flags not in built:
            built[flags] = JEngine(JEngineConfig(**_small(jcfg), **EXACT, **_JAX_FLAGS[flags], ckpt_dir=ckpt_dir,
                                                 persistent_cache=False))
        return built[flags]

    return get


def _port(ckpt_dir, devices=CPU8, **kw):
    return InferenceEngine(EngineConfig(**_small(tcfg), **EXACT, ckpt_dir=ckpt_dir, device="cpu", **kw),
                           devices=devices)


@pytest.mark.parametrize("flags", list(_JAX_FLAGS))
def test_mesh_shape_and_count_match_the_jax_engine(jax_engines, ckpt_dir, flags):
    jeng = jax_engines(flags)
    teng = _port(ckpt_dir, **_JAX_FLAGS[flags])
    try:
        assert teng.mesh_shape == dict(jeng.mesh.shape)
        assert teng.n_tp_sharded == jeng.n_tp_sharded
        assert teng.mesh.shape == tuple(jeng.mesh.shape.values())
    finally:
        teng.close()


def test_tp8_engine_matches_jax_tp_engine_and_unsharded(jax_engines, ckpt_dir):
    jeng = jax_engines("tp")
    teng, plain = _port(ckpt_dir, **_JAX_FLAGS["tp"]), _port(ckpt_dir)
    try:
        assert teng.mesh_shape == {"dp": 1, "sp": 1, "tp": 8} and teng.n_tp_sharded == jeng.n_tp_sharded > 0
        unet = teng.replicas[0]["unet_eval"]
        assert any(isinstance(m, ColumnParallel) for m in unet.modules())
        x = image(np.random.default_rng(3), 2, 16, 16, 1)
        for name in MODEL_NAMES:
            got = teng.fns[name](x)
            np.testing.assert_allclose(got, np.asarray(jeng.fns[name](jnp.asarray(x))), atol=ATOL, err_msg=name)
            np.testing.assert_allclose(got, plain.fns[name](x), atol=ATOL, err_msg=name)
    finally:
        teng.close()
        plain.close()


def test_dp8_engine_matches_jax_dp_engine(jax_engines, ckpt_dir):
    jeng = jax_engines("dp")
    teng = _port(ckpt_dir, **_JAX_FLAGS["dp"])
    try:
        assert teng.mesh_shape == {"dp": 8, "sp": 1, "tp": 1} and len(teng.replicas) == 8
        x = image(np.random.default_rng(4), 8, 16, 16, 1)
        for name in ("nafnet", "hybrid"):
            np.testing.assert_allclose(teng.fns[name](x), np.asarray(jeng.fns[name](jnp.asarray(x))),
                                       atol=ATOL, err_msg=name)
    finally:
        teng.close()


# -- (5)-(11) --------------------------------------------------------------------


def _tiny_demo(**kw):
    return EngineConfig(**_small(tcfg), **EXACT, ckpt_dir="/nonexistent", device="cpu", **kw)


@pytest.mark.parametrize("devices", [None, ["cpu"]])
def test_one_device_makes_every_flag_a_no_op(devices):
    flags = dict(data_parallel=True, tensor_parallel=True, tp_min_size=64, batching=True, batch_buckets=(1, 3))
    plain = InferenceEngine(_tiny_demo(batching=True, batch_buckets=(1, 3)))
    eng = InferenceEngine(_tiny_demo(**flags), devices=devices)
    try:
        assert eng.mesh is None and eng.mesh_shape is None and eng.n_tp_sharded == 0
        assert len(eng.replicas) == 1 and not eng._replicas
        assert not any(isinstance(m, ColumnParallel) for mod in eng.replicas[0].values() if mod is not None
                       for m in mod.modules())
        assert eng.batcher.buckets == plain.batcher.buckets == [1, 3]
        x = image(np.random.default_rng(5), 1, 16, 16, 1)
        for name in MODEL_NAMES:
            np.testing.assert_array_equal(eng.fns[name](x), plain.fns[name](x), err_msg=name)
        assert eng.serving_mode() == plain.serving_mode()
    finally:
        eng.close()
        plain.close()


def test_dp_rows_must_divide_and_buckets_round_up():
    eng = InferenceEngine(_tiny_demo(data_parallel=True), devices=["cpu"] * 2)
    try:
        x1 = image(np.random.default_rng(6), 1, 16, 16, 1)
        with pytest.raises(ValueError, match="does not split over dp=2"):
            eng.fns["nafnet"](x1)
        want = eng.fns["nafnet"](np.concatenate([x1, x1]))[:1]
        assert want.shape == (1, 16, 16, 1)
    finally:
        eng.close()
    batched = InferenceEngine(_tiny_demo(data_parallel=True, batching=True, batch_buckets=(1, 2, 3)),
                              devices=["cpu"] * 2)
    try:
        assert batched.batcher.buckets == [2, 4]
        out = batched.batcher.process(x1)
        np.testing.assert_allclose(out["nafnet"], want, atol=ATOL)
        assert all(out[n] is not None for n in MODEL_NAMES)
    finally:
        batched.close()


def test_bf16_engine_under_tp():
    """The default bf16-eval engine: cast, then split, so the slices hold
    the cast weights; outputs within bf16's rounding of the unsharded
    engine's."""
    kw = dict(**_small(tcfg), ckpt_dir="/nonexistent", device="cpu")
    plain = InferenceEngine(EngineConfig(**kw))
    eng = InferenceEngine(EngineConfig(**kw, tensor_parallel=True, tp_min_size=64), devices=["cpu"] * 2)
    try:
        shards = [s for m in eng.replicas[0]["unet_eval"].modules() if isinstance(m, ColumnParallel)
                  for s in m.shards if isinstance(s, torch.nn.Conv2d)]
        assert shards and all(s.weight.dtype == torch.bfloat16 for s in shards)
        x = image(np.random.default_rng(7), 1, 16, 16, 1)
        for name in MODEL_NAMES:
            np.testing.assert_allclose(eng.fns[name](x), plain.fns[name](x), atol=2.0 ** -7, err_msg=name)
    finally:
        eng.close()
        plain.close()


def test_sees_expert_hybrid_under_tp(tmp_path):
    """The hybrid's expert branch comes from expert_ftl2.pth: split too, and
    counted, as the JAX engine counts it."""
    cfg = tcfg.ExpertConfig(base_channels=8)
    ftl2 = init_weights(ExpertDenoiser(cfg), torch.Generator().manual_seed(9))
    torch.save({"model_state_dict": ftl2.state_dict()}, tmp_path / "expert_ftl2.pth")
    kw = dict(**_small(tcfg), **EXACT, ckpt_dir=str(tmp_path), device="cpu")
    kw["fusion_cfg"] = tcfg.FusionConfig(base_c=16, sees_expert=True)
    plain = InferenceEngine(EngineConfig(**kw))
    eng = InferenceEngine(EngineConfig(**kw, tensor_parallel=True, tp_min_size=64), devices=["cpu"] * 2)
    shared = InferenceEngine(EngineConfig(**{**kw, "ckpt_dir": "/nonexistent"}, tensor_parallel=True,
                                          tp_min_size=64), devices=["cpu"] * 2)
    try:
        assert eng.hybrid_expert_tree == "expert_ftl2" and shared.hybrid_expert_tree == "shared"
        expert_count = count_tp_sharded(param_shardings(ExpertDenoiser(cfg), 2, 64))
        assert eng.n_tp_sharded == shared.n_tp_sharded + expert_count
        hyb_expert = eng.replicas[0]["hyb_expert"]
        assert hyb_expert is not eng.replicas[0]["expert"]
        assert any(isinstance(m, ColumnParallel) for m in hyb_expert.modules())
        x = image(np.random.default_rng(8), 1, 16, 16, 1)
        np.testing.assert_allclose(eng.fns["hybrid"](x), plain.fns["hybrid"](x), atol=ATOL)
    finally:
        for e in (eng, plain, shared):
            e.close()


def test_server_flags_build_the_engine_config(monkeypatch):
    from midd_tpu_torch.serve import server as srv

    seen = {}
    monkeypatch.setattr(srv, "serve_forever", lambda host, port, engine_config: seen.update(cfg=engine_config))
    srv.main(["--dp", "--tp", "--device", "cpu"])
    assert (seen["cfg"].data_parallel, seen["cfg"].tensor_parallel) == (True, True)
    srv.main(["--tp"])
    assert (seen["cfg"].data_parallel, seen["cfg"].tensor_parallel) == (False, True)
    srv.main([])
    assert (seen["cfg"].data_parallel, seen["cfg"].tensor_parallel, seen["cfg"].tp_size) == (False, False, None)


# int8 rollouts that do not start from bit-equal fp32 sums: an activation on
# a rounding boundary of its int8 grid moves by a whole step, and the
# rollout carries it (tests/test_torch_qconv.py::
# test_static_int8_engine_matches_the_jax_engine, whose bounds these are).
# So against the JAX engine, and, for dynamic scales, against the port's
# unsharded engine: CPU BLAS sums a split Linear's (the time MLP's) slice in
# another order than the whole layer (~2e-7 apart), every per-call
# activation scale downstream moves with it, and a 2-step rollout reads
# ~6e-3 apart. One UNet eval holds those apart to 1e-4, as do the static
# scales' rollouts (fixed scales: the slices compute the same integer
# products).
INT8_CHAOS = dict(max=0.05, mean=4e-3, corr=0.9998)
INT8_VS_UNSHARDED = 1e-4


def _assert_int8_close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    diff = np.abs(got - want)
    assert diff.max() < INT8_CHAOS["max"] and diff.mean() < INT8_CHAOS["mean"], (name, diff.max(), diff.mean())
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > INT8_CHAOS["corr"], name


@pytest.mark.parametrize("int8", ["static", True])
def test_int8_tp8_engine_matches_jax_tp_int8_and_unsharded_int8(ckpt_dir, monkeypatch, int8):
    """int8 under tp 8 on ``["cpu"] * 8``: calibrated whole, then split (the
    JAX engine's order, midd_tpu/serve/engine.py:564-571), served with the
    JAX engine's scales (static); ``n_tp_sharded`` is the JAX engine's (its
    scales are 0-d leaves, never split); every int8 slice keeps the layer's
    scale on its own device and its int8 mode."""
    jax_scales = []
    calibrate = JEngine._calibrate_unet

    def keep(self, *args):
        scales = calibrate(self, *args)
        jax_scales.append(qscales_from_jax(scales))
        return scales

    monkeypatch.setattr(JEngine, "_calibrate_unet", keep)
    flags = dict(**_JAX_FLAGS["tp"], quantize_int8=int8)
    jeng = JEngine(JEngineConfig(**_small(jcfg), **EXACT, **flags, ckpt_dir=ckpt_dir, persistent_cache=False))
    carried = iter(jax_scales)
    monkeypatch.setattr(engine_module, "calibrate_unet_rollout", lambda *args: next(carried))
    teng = _port(ckpt_dir, **flags)
    carried = iter(jax_scales)
    plain = _port(ckpt_dir, devices=None, quantize_int8=int8)
    try:
        assert teng.mesh_shape == {"dp": 1, "sp": 1, "tp": 8} and teng.n_tp_sharded == jeng.n_tp_sharded > 0
        for key in ("unet_eval", "hyb_unet_eval"):
            slices = [s for m in teng.replicas[0][key].modules() if isinstance(m, ColumnParallel)
                      for s in m.shards if isinstance(s, QuantConv2d)]
            assert slices and all(s.mode == ("static" if int8 == "static" else "dynamic") for s in slices)
            assert all((s.act_absmax is not None) == (int8 == "static") for s in slices)
            assert all(s.act_absmax.device == s.weight.device for s in slices if s.act_absmax is not None)
        x = image(np.random.default_rng(12), 2, 16, 16, 1)
        xt, t = torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor([3, 5])
        with torch.no_grad():
            one_eval = [e.replicas[0]["unet_eval"](xt, xt, t) for e in (teng, plain)]
        torch.testing.assert_close(one_eval[0], one_eval[1], rtol=0, atol=INT8_VS_UNSHARDED)
        for name in MODEL_NAMES:
            got, want = teng.fns[name](x), np.asarray(jeng.fns[name](jnp.asarray(x)))
            if name in ("nafnet", "expert"):
                np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
                np.testing.assert_allclose(got, plain.fns[name](x), atol=ATOL, err_msg=name)
                continue
            _assert_int8_close(got, want, name)
            if int8 == "static":
                np.testing.assert_allclose(got, plain.fns[name](x), atol=INT8_VS_UNSHARDED, err_msg=name)
            else:
                _assert_int8_close(got, plain.fns[name](x), name)
    finally:
        teng.close()
        plain.close()


def test_a_quantconv_slice_keeps_its_scale_on_its_own_device():
    """On one card, or the CPU, every tp device is the same one, so a scale
    left on the lead device would not fail there: slice onto "meta"."""
    conv = QuantConv2d(4, 8, 3, mode="static")
    conv.act_absmax = torch.tensor(2.5)
    shard = tp_module._slice_layer(conv, 0, 4, 8, "meta")
    assert shard.weight.device.type == shard.act_absmax.device.type == "meta"
    assert shard.mode == "static" and shard.out_channels == 4 and shard.weight.shape == (4, 4, 3, 3)


def test_dp_with_int8_copies_the_calibrated_scales():
    one = InferenceEngine(_tiny_demo(quantize_int8="static"))
    eng = InferenceEngine(_tiny_demo(quantize_int8="static", data_parallel=True), devices=["cpu"] * 2)
    try:
        for r in eng.replicas:
            scales = {n: m.act_absmax for n, m in r["unet_eval"].named_modules() if isinstance(m, QuantConv2d)}
            assert scales and scales.keys() == one.int8_scales["diffusion"].keys()
            for n, s in scales.items():
                torch.testing.assert_close(s, one.int8_scales["diffusion"][n], rtol=0, atol=0)
        x = image(np.random.default_rng(10), 2, 16, 16, 1)
        np.testing.assert_allclose(eng.fns["diffusion"](x), one.fns["diffusion"](x), atol=ATOL)
    finally:
        eng.close()
        one.close()


@pytest.mark.parametrize("flags", [dict(tensor_parallel=True, tp_min_size=64), dict(data_parallel=True),
                                   dict(data_parallel=True, tensor_parallel=True, batching=True, fused_request=True,
                                        adaptive_turbo=True)])
def test_serving_mode_keys_unchanged_under_tp_and_dp(flags):
    extra = {k: v for k, v in flags.items() if k in ("batching", "fused_request", "adaptive_turbo")}
    plain = InferenceEngine(_tiny_demo(**extra))
    eng = InferenceEngine(_tiny_demo(**flags), devices=CPU8)
    try:
        assert eng.mesh is not None
        assert _nested_keys(eng.serving_mode()) == _nested_keys(plain.serving_mode())
        assert eng.serving_mode() == plain.serving_mode()
    finally:
        eng.close()
        plain.close()


def test_fused_and_turbo_paths_split_over_dp_and_tp():
    flags = dict(fused_request=True, adaptive_turbo=True)
    plain = InferenceEngine(_tiny_demo(**flags))
    eng = InferenceEngine(_tiny_demo(**flags, data_parallel=True, tensor_parallel=True, tp_size=2, tp_min_size=64),
                          devices=["cpu"] * 4)
    try:
        assert eng.mesh_shape == {"dp": 2, "sp": 1, "tp": 2}
        x = image(np.random.default_rng(11), 2, 16, 16, 1)
        got, want = eng.fused(x), plain.fused(x)
        for name in MODEL_NAMES:
            np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)
        for name in eng.turbo_fns:
            np.testing.assert_allclose(eng.turbo_fns[name](x), plain.turbo_fns[name](x), atol=ATOL, err_msg=name)
    finally:
        eng.close()
        plain.close()


def test_launch_counts_survive_concurrent_replicas():
    """dp replicas count their kernels from several threads at once: no
    increment may be lost (``_build.count_launch`` takes a lock)."""
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000
