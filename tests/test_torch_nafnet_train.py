"""The port's NAFNet training slice against the JAX package, on the CPU in
fp32: the CombinedLoss and its frequency term, one train step at the CLI's
tiny preset against the JAX train step from the same weights and batch, the
``--model nafnet`` CLI writing a ``nafnet.pth`` that the port's engine
serves, and ``init_from``."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.train import losses as jlosses
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import data as tdata
from midd_tpu_torch.train import losses as tlosses
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, port, rand

TINY = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))


def _grad_parity(jfn, tfn, pred, target):
    """Value and gradient (w.r.t. pred) of a loss on both sides."""
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target))))(jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    tv = tfn(tp, nchw(target))
    tv.backward()
    return float(jv), np.asarray(jg), float(tv.detach()), nhwc(tp.grad)


def test_frequency_loss_matches_jax(rng):
    pred, target = image(rng, 2, 24, 20, 1), image(rng, 2, 24, 20, 1)
    jv, jg, tv, tg = _grad_parity(jlosses.frequency_loss, tlosses.frequency_loss, pred, target)
    # fp32 FFTs in another order (pocketfft against XLA's)
    assert tv == pytest.approx(jv, rel=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-4 * np.abs(jg).max())


def test_combined_loss_nafnet_matches_jax(rng):
    pred, target = image(rng, 2, 24, 20, 1), image(rng, 2, 24, 20, 1)
    jv, jg, tv, tg = _grad_parity(lambda p, t: jlosses.combined_loss_nafnet(p, t)[0],
                                  lambda p, t: tlosses.combined_loss_nafnet(p, t)[0], pred, target)
    assert tv == pytest.approx(jv, rel=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-4 * np.abs(jg).max())
    _, jparts = jlosses.combined_loss_nafnet(jnp.asarray(pred), jnp.asarray(target))
    _, tparts = tlosses.combined_loss_nafnet(nchw(pred), nchw(target))
    assert set(tparts) == set(jparts) == {"mse", "l1", "freq", "edge"}
    for k in jparts:
        assert float(tparts[k]) == pytest.approx(float(jparts[k]), rel=1e-5), k


@pytest.mark.parametrize("variant", ["reference", "l2"])
def test_train_step_matches_the_jax_trainer(rng, tmp_path, variant):
    size, b = 16, 2
    jmodel = jm.EnhancedNAFNet(jcfg.NAFNetConfig(**TINY))
    variables = perturb(jax_init(jmodel, jnp.zeros((1, size, size, 1)), seed=3), rng)
    cfg_kw = dict(epochs=1, batch_size=b, lr=1e-3, ckpt_dir=str(tmp_path))
    jloss_fn = jtrainer.nafnet_loss_fn(jmodel, loss_variant=variant)
    jt = jtrainer.Trainer(jloss_fn, lambda *a: None, jtrainer.TrainConfig(**cfg_kw), variables["params"])
    tmodel = port(EnhancedNAFNet(tcfg.NAFNetConfig(**TINY)), variables)
    tt = ttrainer.Trainer(ttrainer.nafnet_loss_fn(variant), lambda *a: None,
                          ttrainer.TrainConfig(**cfg_kw), tmodel, ttrainer.no_draw, device="cpu")
    clean = image(rng, b, size, size, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, b, size, size, 1), 0, 1).astype(np.float32)
    jbatch = (jnp.asarray(clean), jnp.asarray(noisy))
    params = jt.state.params

    (jl, _), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(params, jbatch, jax.random.PRNGKey(0))
    tl, _ = ttrainer.nafnet_loss_fn(variant)(tmodel, (nchw(clean), nchw(noisy)), None)
    tl.backward()
    # fp32 on both sides, another summation order through ~40 layers
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    jgrads = {k: v.numpy() for k, v in
              state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg)}).items()}
    top = max(np.abs(g).max() for g in jgrads.values())
    for name, p in tmodel.named_parameters():
        g = jgrads[name]
        # each gradient to 1e-4 of its largest entry, floored at 1e-3 of the
        # model's largest, as the diffusion step is held (test_torch_train.py)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-3 * top), err_msg=name)

    tloss = tt.train_step((nchw(clean), nchw(noisy)))
    params, _, jloss = jt._train_step(params, jt.state.opt_state, jbatch, jax.random.PRNGKey(0))
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    for name, v in tmodel.state_dict().items():
        # one Adam step of size ~lr = 1e-3 from the same weights and gradients
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


def _write_pairs(root, rng, n=2, size=20):
    dirs = [root / "clean", root / "noisy"]
    for d in dirs:
        d.mkdir()
    for i in range(n):
        a = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(a).save(dirs[0] / f"img{i}.png")
        Image.fromarray(255 - a).save(dirs[1] / f"img{i}.png")
    return [str(d) for d in dirs]


def test_cli_trains_nafnet_and_the_engine_serves_it(rng, tmp_path, monkeypatch):
    clean_dir, noisy_dir = _write_pairs(tmp_path, rng)
    monkeypatch.chdir(tmp_path)
    st = trecipes.main(["--model", "nafnet", "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
                        "--img-size", "16", "--epochs", "1", "--preset", "tiny", "--device", "cpu",
                        "--loss-variant", "reference"])
    assert len(st.history["losses"]) == 1
    assert np.isfinite(st.history["losses"][0])
    path = tmp_path / "checkpoints" / "nafnet.pth"
    ckpt = load_checkpoint(str(path))
    assert ckpt["epoch"] == 0 and ckpt["width"] == 8 and tuple(ckpt["enc_blk_nums"]) == (1, 1)
    assert ckpt["middle_blk_num"] == 1 and "optimizer_state_dict" in ckpt

    eng = InferenceEngine(EngineConfig(
        img_size=16, ckpt_dir=str(tmp_path / "checkpoints"), device="cpu", warmup=False,
        diffusion_cfg=tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET),
        expert_cfg=tcfg.ExpertConfig(base_channels=8), router_cfg=tcfg.RouterConfig(base_c=8),
        fusion_cfg=tcfg.FusionConfig(base_c=16)))
    try:
        meta = eng.meta["nafnet"]
        assert "demo_weights" not in meta and meta["epoch"] == 0 and meta["width"] == 8
        x = image(rng, 1, 16, 16, 1)
        out = eng.fns["nafnet"](x)
        with torch.no_grad():
            want = st.model.cpu().eval()(nchw(x)).clamp(0, 1)
        np.testing.assert_array_equal(out, nhwc(want))
    finally:
        eng.close()

    # init_from: the parameters of that file, a fresh optimizer and epoch
    ds = tdata.SyntheticPairedDataset(rng.random((2, 16, 16, 1)).astype(np.float32), is_train=False)
    cfg = ttrainer.TrainConfig(epochs=0, ckpt_dir=str(tmp_path / "fine"), ckpt_name="nafnet")
    fine = trecipes.train_nafnet(ds, model_cfg=tcfg.NAFNetConfig(**TINY), train_cfg=cfg,
                                 init_from=str(path), device="cpu")
    assert fine.epoch == 0 and fine.optimizer.state_dict()["state"] == {}
    for k, v in ckpt["model_state_dict"].items():
        assert torch.equal(fine.model.state_dict()[k], v), k
