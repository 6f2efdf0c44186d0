"""``orbax_bridge.py``: the JAX package's orbax checkpoints into the port's
``.pth`` files and back, on the CPU at tiny widths.

(a) JAX init -> orbax (trainer form: params, optimizer state, BatchNorm
    statistics under ``extra``) -> ``to-pth`` -> the port's module loads
    strict and its forward matches JAX's within the suite's ATOL 2e-4; the
    optimizer state is dropped and said to be.
(b) a port ``.pth`` -> ``to-orbax`` -> ``load_checkpoint`` gives arrays
    bit-equal to the port's, for each family and the router+fusion-only
    hybrid; the metadata keys survive both ways.
(c) one committed TPU-trained tree, ``ablation_ckpts/plain_w48/hybrid``
    (router and fusion only), converts, loads strict into the port's router
    and fusion and matches JAX's router and fusion on the same inputs.
(d) ``dir`` on a copy of that checkpoint directory whose backend links
    dangle names the three backends and exits 1.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import orbax_bridge
from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import FusionModule, NoiseAnalyzer, RouterFusion
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.tiny_unet import TinyUNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.utils.checkpoint import save_checkpoint as save_pth
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, rand, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATION = os.path.join(REPO, "ablation_ckpts", "plain_w48")
ATOL = 2e-4  # tests/test_parity_torch.py:31, the suite's tolerance
S = 16

UNET = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1,), time_emb_dim=16)
NAF = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
EXPERT = dict(base_channels=8)
TINY = dict(base_ch=8, time_dim=16)
ROUTER = dict(base_c=8)
FUSION = dict(base_c=16)
FUSION_EXP = dict(base_c=16, residual=True, sees_expert=True)


def _inputs(rng):
    x = jnp.asarray(image(rng, 1, S, S, 1))
    return x, jnp.asarray(rand(rng, 1, S, S, 1) * 0.3), jnp.asarray(np.array([5], np.int32))


def _family(name):
    """(groups, metadata, model flag): each group is (prefix, JAX module,
    a maker of the port module, call) with call naming the forward's inputs."""
    unet = (jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**UNET)),
            lambda: UNetDiffusion(tcfg.DiffusionUNetConfig(**UNET)), "unet")
    naf = (jm.EnhancedNAFNet(jcfg.NAFNetConfig(**NAF)),
           lambda: EnhancedNAFNet(tcfg.NAFNetConfig(**NAF)), "x")
    router = (jm.NoiseAnalyzer(jcfg.RouterConfig(**ROUTER)),
              lambda: NoiseAnalyzer(tcfg.RouterConfig(**ROUTER)), "x")
    if name == "diffusion":
        return [(None, *unet)], {**UNET, "noise_steps": 50}, "diffusion"
    if name == "nafnet":
        return [(None, *naf)], dict(NAF), "nafnet"
    if name == "expert":
        return [(None, jm.ExpertDenoiser(jcfg.ExpertConfig(**EXPERT)),
                 lambda: ExpertDenoiser(tcfg.ExpertConfig(**EXPERT)), "x")], dict(EXPERT), "expert"
    if name == "tiny":
        return [(None, jm.TinyUNet(jcfg.TinyUNetConfig(**TINY)),
                 lambda: TinyUNet(tcfg.TinyUNetConfig(**TINY)), "tiny")], dict(TINY), "tiny"
    fusion_kw = FUSION if name == "hybrid" else FUSION_EXP
    fusion = (jm.FusionModule(jcfg.FusionConfig(**fusion_kw)),
              lambda: FusionModule(tcfg.FusionConfig(**fusion_kw)),
              "fusion4" if fusion_kw.get("sees_expert") else "fusion3")
    meta = {"router_params": dict(ROUTER), "fusion_params": dict(fusion_kw)}
    groups = [("router", *router), ("fusion", *fusion)]
    if name == "hybrid":  # all four groups, as the reference saves a hybrid
        groups = [("nafnet", *naf), ("diffusion_unet", *unet)] + groups
        meta.update(nafnet_params=dict(NAF), diffusion_params={**UNET, "noise_steps": 50})
    return groups, meta, "hybrid"


def _jax_args(call, x, cond, t):
    return {"unet": (x, cond, t), "x": (x,), "tiny": (x, t, cond),
            "fusion3": (x, cond, x), "fusion4": (x, cond, x, cond)}[call]


def _torch_forward(module, call, x, cond, t):
    xt, ct, tt = nchw(np.asarray(x)), nchw(np.asarray(cond)), torch.from_numpy(np.asarray(t).astype(np.int64))
    with torch.no_grad():
        return nhwc({"unet": lambda: module(xt, ct, tt), "x": lambda: module(xt),
                     "tiny": lambda: module(xt, tt, ct), "fusion3": lambda: module(xt, ct, xt),
                     "fusion4": lambda: module(xt, ct, xt, ct)}[call]())


def _port_module(groups):
    if groups[0][0] is None:
        return groups[0][2]()
    return torch.nn.ModuleDict({prefix: build() for prefix, _, build, _ in groups})


FAMILIES = ["diffusion", "nafnet", "expert", "tiny", "hybrid", "hybrid_router_fusion"]


@pytest.mark.parametrize("family", FAMILIES)
def test_orbax_to_pth_loads_strict_and_matches_jax(family, tmp_path, rng, capsys):
    groups, arch, _ = _family(family)
    x, cond, t = _inputs(rng)
    variables = {}
    for prefix, jmod, _, call in groups:
        variables[prefix] = perturb(jax_init(jmod, *_jax_args(call, x, cond, t),
                                             seed=int(rng.integers(1 << 30))), rng)
    if groups[0][0] is None:
        v = variables[None]
        tree = {"params": v["params"], "opt_state": [{"count": np.int32(3)}, {"mu": v["params"]}]}
        if "batch_stats" in v:  # the JAX trainer keeps them under "extra"
            tree["extra"] = {"batch_stats": v["batch_stats"]}
    else:
        tree = {"params": {p: v["params"] for p, v in variables.items()},
                "opt_state": [{"count": np.int32(3)}]}
    meta = {"epoch": 4, "best_psnr": 31.5, "losses": [0.5, 0.25], **arch}
    src = str(tmp_path / "ckpt")
    save_checkpoint(src, tree, meta)

    out = str(tmp_path / "ckpt.pth")
    assert orbax_bridge.main(["to-pth", src, out]) == 0
    assert "dropped opt_state" in capsys.readouterr().out
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    assert set(meta) | {"model_state_dict"} == set(ckpt)
    assert all(ckpt[k] == v for k, v in json.loads(json.dumps(meta)).items())  # tuples are lists
    module = _port_module(groups)
    module.load_state_dict(ckpt["model_state_dict"], strict=True)
    module.eval()
    for prefix, jmod, _, call in groups:
        want = np.asarray(jax.jit(jmod.apply)(variables[prefix], *_jax_args(call, x, cond, t)))
        got = _torch_forward(module if prefix is None else module[prefix], call, x, cond, t)
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=str(prefix))


@pytest.mark.parametrize("family", FAMILIES)
def test_pth_to_orbax_is_bit_equal(family, tmp_path, rng):
    groups, arch, model = _family(family)
    module = _port_module(groups)
    init_weights(module, torch.Generator().manual_seed(int(rng.integers(1 << 30))))
    sd = module.state_dict()
    for k, v in sd.items():  # BatchNorm statistics that are not (0, 1)
        if k.endswith("running_mean") or k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32)))
    meta = {"epoch": 2, "best_ssim": 0.75, "psnrs": [20.0, 21.5], **arch}
    pth = str(tmp_path / "model.pth")
    save_pth(pth, sd, {"state": {}, "param_groups": []}, meta)

    out = str(tmp_path / "orbax")
    assert orbax_bridge.main(["to-orbax", pth, out, "--model", model]) == 0
    tree, got_meta = load_checkpoint(out)
    assert set(got_meta) == set(meta)
    assert got_meta["epoch"] == 2 and got_meta["psnrs"] == [20.0, 21.5]
    back = state_dict_from_jax(to_numpy_tree(orbax_bridge._variables(tree)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    if model == "hybrid":  # the tree the JAX trainer writes: groups under "params"
        assert set(tree) == {"params"}
        assert set(tree["params"]) == {p for p, *_ in groups}


def test_committed_ablation_tree_converts_and_matches_jax(tmp_path, rng):
    src = os.path.join(ABLATION, "hybrid")
    out = str(tmp_path / "hybrid.pth")
    assert orbax_bridge.main(["to-pth", src, out]) == 0
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    tree, meta = load_checkpoint(src)
    assert ckpt["best_psnr"] == meta["best_psnr"] and ckpt["fusion_params"] == meta["fusion_params"]
    router_cfg = tcfg.RouterConfig(**meta["router_params"])
    fusion_cfg = tcfg.FusionConfig(**meta["fusion_params"])
    ours = RouterFusion(router_cfg, fusion_cfg)
    ours.load_state_dict(ckpt["model_state_dict"], strict=True)
    ours.eval()
    n = sum(int(v.numel()) for v in ckpt["model_state_dict"].values())
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(tree["params"]))

    params = to_numpy_tree(tree["params"])
    x, d, m = (image(rng, 1, 32, 32, 1) for _ in range(3))
    jrouter = jm.NoiseAnalyzer(jcfg.RouterConfig(**meta["router_params"]))
    jfusion = jm.FusionModule(jcfg.FusionConfig(**meta["fusion_params"]))
    want_r = np.asarray(jax.jit(jrouter.apply)({"params": params["router"]}, jnp.asarray(x)))
    want_f = np.asarray(jax.jit(jfusion.apply)({"params": params["fusion"]},
                                               jnp.asarray(x), jnp.asarray(d), jnp.asarray(m)))
    with torch.no_grad():
        got_r = nhwc(ours.router(nchw(x)))
        got_f = nhwc(ours.fusion(nchw(x), nchw(d), nchw(m)))
    np.testing.assert_allclose(got_r, want_r, atol=ATOL)
    np.testing.assert_allclose(got_f, want_f, atol=ATOL)


def test_dir_names_the_dangling_backends_and_fails(tmp_path, capsys):
    src = tmp_path / "plain_w48"
    src.mkdir()
    shutil.copytree(os.path.join(ABLATION, "hybrid"), src / "hybrid")
    for name in ("diffusion", "expert", "nafnet"):  # links of its own, dangling
        os.symlink(str(tmp_path / "absent" / name), str(src / name))
    out = tmp_path / "out"
    assert orbax_bridge.main(["dir", str(src), str(out)]) == 1
    err = capsys.readouterr().err
    for name in ("diffusion", "expert", "nafnet"):
        assert f"cannot read {src / name}: a dangling symlink" in err, err
    assert "not converted (3): diffusion, expert, nafnet" in err
    assert sorted(os.listdir(out)) == ["hybrid.pth"]


def test_port_refuses_orbax_with_the_bridge_command(tmp_path):
    """The engine and the recipes' backend loader still refuse an orbax
    directory, and name the command that converts it."""
    from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    from midd_tpu_torch.train import recipes

    for name in ("diffusion", "nafnet"):
        (tmp_path / name).mkdir()
    cmd = "python orbax_bridge.py to-pth {0} {0}.pth"
    with pytest.raises(NotImplementedError) as e:
        InferenceEngine(EngineConfig(ckpt_dir=str(tmp_path), device="cpu", warmup=False))
    assert cmd.format(tmp_path / "diffusion") in str(e.value)
    with pytest.raises(NotImplementedError) as e:
        recipes._load_backend(str(tmp_path / "nafnet"), EnhancedNAFNet(tcfg.NAFNetConfig(**NAF)),
                              "nafnet", [])
    assert cmd.format(tmp_path / "nafnet") in str(e.value)


def test_config_fields_match(rng):
    """The bridge builds JAX configs from the port's metadata keys: every
    field of the port's configs is a field of the JAX ones."""
    for t, j in ((tcfg.DiffusionUNetConfig, jcfg.DiffusionUNetConfig), (tcfg.NAFNetConfig, jcfg.NAFNetConfig),
                 (tcfg.ExpertConfig, jcfg.ExpertConfig), (tcfg.TinyUNetConfig, jcfg.TinyUNetConfig),
                 (tcfg.RouterConfig, jcfg.RouterConfig), (tcfg.FusionConfig, jcfg.FusionConfig)):
        assert {f.name for f in dataclasses.fields(t)} <= {f.name for f in dataclasses.fields(j)}, t
