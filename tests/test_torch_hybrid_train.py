"""The port's hybrid training slice against the JAX package, on the CPU in
fp32: the PerceptualLoss, one train step of the router and the fusion on
frozen backends against the JAX train step (``hybrid_loss_fn`` with
``frozen``) from the same weights and batch, with and without the expert
branch, and the ``--model hybrid`` CLI on the backends that the nafnet and
diffusion CLIs wrote, whose ``hybrid.pth`` the port's engine serves."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.diffusion import make_schedule as jmake_schedule
from midd_tpu.train import losses as jlosses
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import init_weights
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.models.hybrid import RouterFusion
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import losses as tlosses
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, port, rand

SIZE, BATCH, STEPS = 16, 2, 3  # the CLI's tiny preset rolls out 3 steps
TINY_UNET = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1,), time_emb_dim=16)
TINY_NAF = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_perceptual_loss_hybrid_matches_jax(rng):
    # 22 x 18: the 2x and 4x pools drop a ragged row and column
    pred, target = image(rng, 2, 22, 18, 1), image(rng, 2, 22, 18, 1)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jlosses.perceptual_loss_hybrid(p, jnp.asarray(target))))(jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    tv = tlosses.perceptual_loss_hybrid(tp, nchw(target))
    tv.backward()
    # fp32 means in another order
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(nhwc(tp.grad), np.asarray(jg), atol=1e-4 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("sees_expert", [False, True])
def test_hybrid_train_step_matches_jax(rng, tmp_path, sees_expert):
    x0 = jnp.zeros((1, SIZE, SIZE, 1))
    jnaf = jm.EnhancedNAFNet(jcfg.NAFNetConfig(**TINY_NAF))
    junet = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**TINY_UNET), use_flash=False)
    jrouter = jm.NoiseAnalyzer(jcfg.RouterConfig(base_c=8))
    fusion_cfg = dict(base_c=16, sees_expert=sees_expert)
    jfusion = jm.FusionModule(jcfg.FusionConfig(**fusion_cfg))
    jexpert = jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=8)) if sees_expert else None
    jsched = jmake_schedule(jcfg.SERVE_SCHEDULE)
    frozen = {"nafnet": perturb(jax_init(jnaf, x0, seed=1), rng)["params"],
              "unet": jax_init(junet, x0, x0, jnp.zeros((1,), jnp.int32), seed=2)["params"]}
    if sees_expert:
        frozen["expert"] = perturb(jax_init(jexpert, x0, seed=5), rng)
    trainable = {"router": perturb(jax_init(jrouter, x0, seed=3), rng)["params"],
                 "fusion": perturb(jax_init(jfusion, *(x0,) * (4 if sees_expert else 3), seed=4), rng)["params"]}
    cfg_kw = dict(epochs=1, batch_size=BATCH, lr=1e-3, ckpt_dir=str(tmp_path), ckpt_name="hybrid")
    jloss_fn = jtrainer.hybrid_loss_fn(jnaf, junet, jrouter, jfusion, jsched, STEPS, expert_model=jexpert)
    jt = jtrainer.Trainer(jloss_fn, lambda *a: None, jtrainer.TrainConfig(**cfg_kw), trainable, frozen=frozen)

    tfrozen = {"nafnet": port(EnhancedNAFNet(tcfg.NAFNetConfig(**TINY_NAF)), {"params": frozen["nafnet"]}),
               "unet": port(UNetDiffusion(tcfg.DiffusionUNetConfig(**TINY_UNET)), {"params": frozen["unet"]})}
    if sees_expert:
        tfrozen["expert"] = port(ExpertDenoiser(tcfg.ExpertConfig(base_channels=8)), frozen["expert"])
    frozen_before = {k: {n: v.clone() for n, v in m.state_dict().items()} for k, m in tfrozen.items()}
    tmodel = RouterFusion(tcfg.RouterConfig(base_c=8), tcfg.FusionConfig(**fusion_cfg))
    tmodel.load_state_dict(state_dict_from_jax({"params": trainable}), strict=True)
    tsched = make_schedule(tcfg.SERVE_SCHEDULE)
    tt = ttrainer.Trainer(ttrainer.hybrid_loss_fn(tsched, STEPS), lambda *a: None,
                          ttrainer.TrainConfig(**cfg_kw), tmodel, ttrainer.no_draw, frozen=tfrozen,
                          device="cpu")
    assert {id(p) for p in tt.params} == {id(p) for p in tmodel.parameters()}
    assert all(not p.requires_grad for m in tfrozen.values() for p in m.parameters())

    clean = image(rng, BATCH, SIZE, SIZE, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
    jbatch = (jnp.asarray(clean), jnp.asarray(noisy))
    key = jax.random.PRNGKey(0)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(p, jbatch, key, jt.frozen)[0]))(jt.state.params)
    tloss = tt.train_step((nchw(clean), nchw(noisy)))
    params, _, jloss = jt._train_step(jt.state.params, jt.state.opt_state, jbatch, key, jt.frozen)
    # fp32 on both sides, another summation order through the three backends
    # and ~20 router and fusion layers
    assert tloss == pytest.approx(float(jl), rel=1e-5) and tloss == pytest.approx(float(jloss), rel=1e-5)

    jgrads = {k: v.numpy() for k, v in state_dict_from_jax({"params": _np_tree(jg)}).items()}
    assert set(jgrads) == {n for n, _ in tmodel.named_parameters()}
    clip = min(1.0, 1.0 / np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in jgrads.values())))
    top = max(np.abs(g).max() for g in jgrads.values())
    want = state_dict_from_jax({"params": _np_tree(params)})
    n_noise = 0
    for n, p in tmodel.named_parameters():
        g = clip * jgrads[n]
        scale = max(np.abs(g).max(), 1e-3 * clip * top)
        # the step's clipped gradients: 1e-4 of the largest entry, floored at
        # 1e-3 of the model's largest (test_torch_nafnet_train.py)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3, atol=1e-4 * scale, err_msg=n)
        # one Adam step of size ~lr = 1e-3 from the same weights; where the
        # gradient is within twice its bound above, its sign is not fixed and
        # Adam's first step (~ lr * g / |g|) is anywhere in +-lr: among them
        # the router's enc1 and dec2 conv biases, in front of GroupNorms with
        # one channel a group, which have no gradient in exact arithmetic
        noise = np.abs(g) < 2e-4 * scale
        n_noise += int(noise.sum())
        diff = np.abs(p.detach().numpy() - want[n].numpy())
        assert (diff[~noise] <= 2e-5).all(), (n, diff[~noise].max())
        assert (diff[noise] <= 2e-3).all(), (n, diff.max())
    assert n_noise <= 0.02 * sum(p.numel() for p in tmodel.parameters()), n_noise

    for k, m in tfrozen.items():
        assert not m.training
        for n, v in m.state_dict().items():
            assert torch.equal(v, frozen_before[k][n]), (k, n)
    saved = load_checkpoint(tt.save())["model_state_dict"]
    assert saved and all(k.startswith(("router.", "fusion.")) for k in saved)
    assert set(saved) == set(tmodel.state_dict())


def test_load_backend_falls_back_to_seeded_weights_and_refuses_orbax(tmp_path, capsys):
    build = lambda: EnhancedNAFNet(tcfg.NAFNetConfig(**TINY_NAF))  # noqa: E731
    names = []
    seeded = trecipes._load_backend(None, build(), "nafnet", names).state_dict()
    missing = trecipes._load_backend(str(tmp_path / "absent.pth"), build(), "unet", names).state_dict()
    want = init_weights(build(), torch.Generator().manual_seed(trecipes.BACKEND_SEED)).state_dict()
    for k, v in want.items():
        assert torch.equal(seeded[k], v) and torch.equal(missing[k], v), k
    # each fallback is said and recorded
    assert names == ["nafnet", "unet"]
    said = capsys.readouterr().out
    assert "nafnet backend: no checkpoint at None" in said and "absent.pth" in said
    assert said.count(f"seed {trecipes.BACKEND_SEED}") == 2
    (tmp_path / "nafnet").mkdir()
    with pytest.raises(NotImplementedError, match="orbax_bridge.py to-pth"):
        trecipes._load_backend(str(tmp_path / "nafnet"), build(), "nafnet", names)


def _write_pairs(root, rng, n=2, size=20):
    dirs = [root / "clean", root / "noisy"]
    for d in dirs:
        d.mkdir()
    for i in range(n):
        a = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(a).save(dirs[0] / f"img{i}.png")
        # the hybrid recipe matches noisy files whose name holds the clean stem
        Image.fromarray(255 - a).save(dirs[1] / f"gauss_img{i}.png")
    return [str(d) for d in dirs]


def test_cli_trains_hybrid_on_trained_backends_and_the_engine_serves_it(rng, tmp_path, monkeypatch):
    clean_dir, noisy_dir = _write_pairs(tmp_path, rng)
    common = ["--clear-dir", clean_dir, "--noisy-dirs", noisy_dir, "--img-size", "16", "--epochs", "1",
              "--preset", "tiny", "--device", "cpu"]
    monkeypatch.chdir(tmp_path)
    # the backends: the standalone NAFNet and diffusion CLIs on the same pairs
    # (the diffusion recipe matches names exactly: give it a copy of its own)
    exact = tmp_path / "exact"
    exact.mkdir()
    for i in range(2):
        (exact / f"img{i}.png").write_bytes((tmp_path / "noisy" / f"gauss_img{i}.png").read_bytes())
    backend = ["--clear-dir", clean_dir, "--noisy-dirs", str(exact)] + common[4:]
    trecipes.main(["--model", "nafnet", *backend])
    trecipes.main(["--model", "diffusion", "--batch-size", "1", *backend])
    ckpts = tmp_path / "checkpoints"
    st = trecipes.main(["--model", "hybrid", "--batch-size", "2", *common,
                        "--nafnet-ckpt", str(ckpts / "nafnet.pth"),
                        "--diffusion-ckpt", str(ckpts / "diffusion.pth")])
    assert len(st.history["losses"]) == 1 and np.isfinite(st.history["losses"][0])
    ckpt = load_checkpoint(str(ckpts / "hybrid.pth"))
    assert ckpt["epoch"] == 0 and "optimizer_state_dict" in ckpt
    assert ckpt["nafnet_params"]["width"] == 8 and ckpt["diffusion_params"]["model_channels"] == 8
    assert ckpt["diffusion_params"]["noise_steps"] == 50
    assert ckpt["router_params"]["base_c"] == 8 and ckpt["fusion_params"]["base_c"] == 16
    assert ckpt["fusion_params"]["sees_expert"] is False and "expert_params" not in ckpt
    assert all(k.startswith(("router.", "fusion.")) for k in ckpt["model_state_dict"])
    assert ckpt["seeded_backends"] == []  # both backends came from their checkpoints

    eng = InferenceEngine(EngineConfig(
        img_size=16, ckpt_dir=str(ckpts), device="cpu", warmup=False,
        nafnet_cfg=trecipes.TINY_NAFNET, diffusion_cfg=tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET),
        expert_cfg=trecipes.TINY_EXPERT, router_cfg=tcfg.RouterConfig(base_c=8),
        fusion_cfg=tcfg.FusionConfig(base_c=16), hybrid_diffusion_steps=STEPS,
        hybrid_turbo_eps_reuse=1, hybrid_rollout_bf16=False))
    try:
        meta = eng.meta["hybrid"]
        assert "demo_weights" not in meta and meta["epoch"] == 0
        x = image(rng, 1, 16, 16, 1)
        out = eng.fns["hybrid"](x)
        # the served hybrid is the trained router and fusion on the backends
        # the engine loaded from the same nafnet.pth and diffusion.pth
        frozen = {"nafnet": trecipes._load_backend(str(ckpts / "nafnet.pth"),
                                                   EnhancedNAFNet(trecipes.TINY_NAFNET), "nafnet", []).eval(),
                  "unet": trecipes._load_backend(str(ckpts / "diffusion.pth"),
                                                 UNetDiffusion(tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET)),
                                                 "diffusion", []).eval()}
        with torch.no_grad():
            want = ttrainer.hybrid_apply(st.model.cpu().eval(), frozen, nchw(x),
                                         make_schedule(tcfg.SERVE_SCHEDULE), STEPS).clamp(0, 1)
        np.testing.assert_allclose(out, nhwc(want), atol=1e-6)
    finally:
        eng.close()
