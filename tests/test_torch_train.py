"""The port's training slice against the JAX package, on the CPU in fp32.

(c) losses and metrics against the JAX functions and the skimage oracle;
(d) the learning-rate schedule, and AdamW + global-norm clip on identical
    gradients against ``make_optimizer``/optax, a clipped and a non-finite case
    included;
(e) two train steps of the port's Trainer at the CLI's tiny preset against
    the JAX train step, from weights carried across by ``state_dict_from_jax``
    and fed the same (t, x_t, eps) draws;
(f) the data pipeline's arrays against ``midd_tpu.train.data``;
(g) the ``.pth`` checkpoint: save -> resume, and the port's engine serving
    what the port's trainer wrote;
(h) the CLI refuses the recipes that are not ported (the NAFNet recipe:
    tests/test_torch_nafnet_train.py).
"""

import dataclasses
import os

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
from midd_tpu.train import data as jdata
from midd_tpu.train import losses as jlosses
from midd_tpu.train import metrics as jmetrics
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.diffusion import sampler as tsampler
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import data as tdata
from midd_tpu_torch.train import losses as tlosses
from midd_tpu_torch.train import metrics as tmetrics
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils.checkpoint import load_checkpoint
from tests.skimage_oracle import peak_signal_noise_ratio, structural_similarity
from tests.torch_port_util import image, jax_init, nchw, port, rand
from midd_tpu_torch.convert.from_jax import state_dict_from_jax

TINY = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1,), time_emb_dim=16)


# -- (c) losses and metrics ----------------------------------------------------


def _pairs(rng, n=3, h=33, w=32):
    clean = rng.random((n, h, w)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape).astype(np.float32), 0, 1)
    return clean, noisy


def test_psnr_ssim_match_jax_and_skimage(rng):
    clean, noisy = _pairs(rng)
    tp = tmetrics.psnr(torch.from_numpy(noisy), torch.from_numpy(clean)).numpy()
    ts = tmetrics.ssim(torch.from_numpy(noisy), torch.from_numpy(clean)).numpy()
    jp = np.asarray(jmetrics.psnr(jnp.asarray(noisy), jnp.asarray(clean)))
    js = np.asarray(jmetrics.ssim(jnp.asarray(noisy), jnp.asarray(clean)))
    # fp32 against fp32 in another summation order; the oracle runs in fp64,
    # at the JAX package's own bounds (tests/test_metrics.py)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    for i in range(clean.shape[0]):
        assert tp[i] == pytest.approx(peak_signal_noise_ratio(clean[i], noisy[i]), abs=1e-3)
        assert ts[i] == pytest.approx(structural_similarity(clean[i], noisy[i]), abs=2e-4)


@pytest.mark.parametrize("flat", [False, True])
def test_compute_metrics_matches_jax(rng, flat):
    clean, noisy = _pairs(rng, n=2)
    noisy = noisy * 1.3 - 0.1  # out of [0, 1]: exercises the clip
    if flat:
        clean[1] = 0.25
    tp, ts = tmetrics.compute_metrics(torch.from_numpy(noisy)[:, None], torch.from_numpy(clean)[:, None],
                                      flat_psnr_fallback=flat)
    jp, js = jmetrics.compute_metrics(jnp.asarray(noisy)[..., None], jnp.asarray(clean)[..., None],
                                      flat_psnr_fallback=flat)
    assert float(tp) == pytest.approx(float(jp), abs=1e-4)
    assert float(ts) == pytest.approx(float(js), abs=1e-5)


def test_metrics_refuse_multichannel():
    with pytest.raises(ValueError, match="single-channel"):
        tmetrics.psnr(torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 8))


def test_diffusion_loss_and_edge_loss_match_jax(rng):
    b, h, w = 2, 24, 20
    eps_pred = 3.0 * rand(rng, b, h, w, 1)  # some beyond the +-5 clamp
    eps_true = rand(rng, b, h, w, 1)
    clean = image(rng, b, h, w, 1)
    x_t = image(rng, b, h, w, 1) + 0.3 * rand(rng, b, h, w, 1)
    ah = np.asarray([0.3, 0.9], np.float32)
    jl, jparts = jlosses.diffusion_loss(*(jnp.asarray(a) for a in (eps_pred, eps_true, x_t, clean, ah)))
    tl, tparts = tlosses.diffusion_loss(nchw(eps_pred), nchw(eps_true), nchw(x_t), nchw(clean),
                                        torch.from_numpy(ah))
    # fp32 means over ~1000 elements in another order
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for k in ("mse", "edge"):
        assert float(tparts[k]) == pytest.approx(float(jparts[k]), rel=1e-5)
    for eps in (1e-6, 1e-8):
        assert float(tlosses.edge_loss(nchw(clean), nchw(x_t), eps)) == pytest.approx(
            float(jlosses.edge_loss(jnp.asarray(clean), jnp.asarray(x_t), eps)), rel=1e-5)
    assert float(tlosses.l1(nchw(clean), nchw(x_t))) == pytest.approx(
        float(jlosses.l1(jnp.asarray(clean), jnp.asarray(x_t))), rel=1e-6)


def test_noise_images_and_timesteps_follow_the_jax_formulas():
    sched_t = make_schedule(tcfg.SERVE_SCHEDULE)
    sched_j = jmake_schedule(jcfg.SERVE_SCHEDULE)
    gen = torch.Generator().manual_seed(3)
    t = tsampler.sample_timesteps(gen, 4096, 50)
    assert t.dtype == torch.int64 and int(t.min()) >= 1 and int(t.max()) <= 49
    assert len(torch.unique(t)) == 49  # every t in [1, 50) is drawn
    jt = np.asarray(jsample_timesteps(jax.random.PRNGKey(0), 4096, 50))
    assert jt.min() >= 1 and jt.max() <= 49
    x = torch.rand(3, 1, 8, 8, generator=gen)
    tt = torch.tensor([1, 20, 49])
    x_t, eps = tsampler.noise_images(x, tt, sched_t, gen)
    ah = np.asarray(sched_j.alpha_hat)[tt.numpy()][:, None, None, None]
    want = np.sqrt(ah) * x.numpy() + np.sqrt(1 - ah) * eps.numpy()
    np.testing.assert_allclose(x_t.numpy(), want, atol=1e-6)
    # same formula and dtype as the JAX function on an eps it drew
    jx, jeps = jnoise_images(jnp.asarray(x.numpy()), jnp.asarray(tt.numpy()), sched_j, jax.random.PRNGKey(1))
    ah_j = np.asarray(sched_j.alpha_hat)[tt.numpy()][:, None, None, None]
    np.testing.assert_allclose(np.asarray(jx), np.sqrt(ah_j) * x.numpy() + np.sqrt(1 - ah_j) * np.asarray(jeps),
                               atol=1e-6)


# -- (d) schedule and optimizer ------------------------------------------------


@pytest.mark.parametrize("kw", [dict(epochs=10, lr=1e-3, warmup_epochs=2, eta_min_factor=0.01),
                                dict(epochs=30, lr=2e-4), dict(epochs=5, lr=4e-4, eta_min_factor=0.02)])
def test_lr_schedule_matches_jax(kw):
    ts = ttrainer.lr_schedule_per_epoch(ttrainer.TrainConfig(**kw))
    js = jtrainer.lr_schedule_per_epoch(jtrainer.TrainConfig(**kw))
    for epoch in range(kw["epochs"]):
        assert ts(epoch) == pytest.approx(js(epoch), rel=1e-12)


def test_train_config_fields_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ttrainer.TrainConfig)}
    assert got == want


def _optax_step(params, grads, loss, cfg, lr, state=None):
    tx = jtrainer.make_optimizer(cfg)
    state = tx.init(params) if state is None else state
    jtrainer.set_lr(state, lr)
    return jtrainer.finite_update(jnp.asarray(loss), grads, params, state, tx)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # unclipped; clipped (||g|| >> clip 1.0)
def test_adamw_with_clip_matches_optax(rng, grad_scale):
    cfg = ttrainer.TrainConfig(lr=1e-2, weight_decay=1e-2, grad_clip=1.0)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rand(rng, *s) for k, s in shapes.items()}
    g_steps = [{k: grad_scale * rand(rng, *s) for k, s in shapes.items()} for _ in range(3)]

    params = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in shapes]
    opt = ttrainer.make_optimizer(cfg, params)
    jp, jstate = {k: jnp.asarray(v) for k, v in p0.items()}, None
    for i, g in enumerate(g_steps):
        lr = 1e-2 / (i + 1)
        ttrainer.set_lr(opt, lr)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        assert ttrainer.finite_update(torch.tensor(1.0), params, opt, cfg.grad_clip)
        jp, jstate = _optax_step(jp, {k: jnp.asarray(v) for k, v in g.items()}, 1.0, cfg, lr, jstate)
        for p, k in zip(params, shapes):
            # fp32 updates of size ~lr in another operation order
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_nonfinite_loss_leaves_params_and_moments_alone(rng):
    cfg = ttrainer.TrainConfig(lr=0.1)
    p = torch.nn.Parameter(torch.ones(3))
    opt = ttrainer.make_optimizer(cfg, [p])
    p.grad = torch.ones(3)
    assert ttrainer.finite_update(torch.tensor(1.0), [p], opt, 1.0)
    after_one = (p.detach().clone(), {k: v.clone() for k, v in opt.state[p].items()})
    p.grad = torch.full((3,), 5.0)
    for bad in (float("nan"), float("inf")):
        assert not ttrainer.finite_update(torch.tensor(bad), [p], opt, 1.0)
    assert torch.equal(p.detach(), after_one[0])
    for k, v in opt.state[p].items():
        assert torch.equal(v, after_one[1][k]), k
    # the JAX package leaves its optax state alone the same way
    jp = {"w": jnp.ones(3)}
    _, jstate = _optax_step(jp, {"w": jnp.ones(3)}, 1.0, cfg, 0.1)
    jp2, jstate2 = _optax_step(jp, {"w": jnp.ones(3)}, float("nan"), cfg, 0.1, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(jstate2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_clip_has_no_epsilon():
    g = [torch.tensor([3.0, 4.0])]  # norm exactly 5
    norm = ttrainer.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    np.testing.assert_array_equal(g[0].numpy(), np.asarray([0.6, 0.8], np.float32))


# -- (e) two train steps against the JAX train step ------------------------------


def test_two_train_steps_match_the_jax_trainer(rng, tmp_path):
    size, b = 16, 2
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**TINY), use_flash=False)
    jsched = jmake_schedule(jcfg.SERVE_SCHEDULE)
    x0 = jnp.zeros((1, size, size, 1))
    variables = jax_init(jmodel, x0, x0, jnp.zeros((1,), jnp.int32), seed=3)
    cfg_kw = dict(epochs=1, batch_size=b, lr=1e-3, ckpt_dir=str(tmp_path))
    jt = jtrainer.Trainer(jtrainer.diffusion_loss_fn(jmodel, jsched), lambda *a: None,
                          jtrainer.TrainConfig(**cfg_kw), variables["params"])
    jloss_fn = jtrainer.diffusion_loss_fn(jmodel, jsched)

    tmodel = port(UNetDiffusion(tcfg.DiffusionUNetConfig(**TINY)), variables)
    tsched = make_schedule(tcfg.SERVE_SCHEDULE)
    draws = []
    tt = ttrainer.Trainer(ttrainer.diffusion_loss_fn(tsched), lambda *a: None,
                          ttrainer.TrainConfig(**cfg_kw), tmodel,
                          draw_fn=lambda batch, gen: draws.pop(0), device="cpu")
    names = list(state_dict_from_jax(variables))
    params, opt_state = jt.state.params, jt.state.opt_state
    key = jax.random.PRNGKey(7)
    # Entries whose gradient is at rounding-noise level (below 1e-6 of the
    # largest): chiefly those that are zero in exact arithmetic, the key
    # third of each qkv bias (softmax ignores a shift common to all keys)
    # and, at these widths, the per-channel shifts (conv biases, the time
    # embedding) in front of GroupNorms with one channel per group. Adam's
    # first steps (~ lr * g / (|g| + eps)) turn noise into moves anywhere in
    # +-lr, so those entries are held to that bound only.
    noise = {}
    for step in range(2):
        clean, noisy = image(rng, b, size, size, 1), image(rng, b, size, size, 1)
        key, sub = jax.random.split(key)
        # the JAX loss's own draws from ``sub`` (trainer.py:203-206)
        k_t, k_eps = jax.random.split(sub)
        t = jsample_timesteps(k_t, b, jsched.noise_steps)
        x_t, eps = jnoise_images(jnp.asarray(clean), t, jsched, k_eps)
        draw = (torch.from_numpy(np.array(t)).long(), nchw(np.array(x_t)), nchw(np.array(eps)))
        batch = (nchw(clean), nchw(noisy))

        (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(params, (jnp.asarray(clean), jnp.asarray(noisy)), sub)
        tmodel.zero_grad(set_to_none=True)
        tl, _ = ttrainer.diffusion_loss_fn(tsched)(tmodel, batch, draw)
        tl.backward()
        # fp32 on both sides, another summation order through ~30 layers
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
        jgrads = {k: v.numpy() for k, v in
                  state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg)}).items()}
        tgrads = dict(tmodel.named_parameters())
        top = max(np.abs(g).max() for g in jgrads.values())
        for n in names:
            g = jgrads[n]
            noise[n] = noise.get(n, False) | (np.abs(g) < 1e-6 * top)
            np.testing.assert_allclose(tgrads[n].grad.numpy(), g, rtol=1e-3,
                                       atol=1e-4 * max(np.abs(g).max(), 1e-3 * top), err_msg=n)

        draws.append(draw)
        tloss = tt.train_step(batch)
        params, opt_state, jloss = jt._train_step(params, opt_state, (jnp.asarray(clean), jnp.asarray(noisy)), sub)
        assert tloss == pytest.approx(float(jloss), rel=1e-5)
        want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
        got = tmodel.state_dict()
        n_noise = sum(int(m.sum()) for m in noise.values())
        assert n_noise <= 0.02 * sum(m.size for m in noise.values()), n_noise  # 1.2% here
        for n in names:
            # one or two Adam steps of size ~lr = 1e-3 from the same weights;
            # a noise-gradient entry only within Adam's step bound
            diff = np.abs(got[n].numpy() - want[n].numpy())
            assert (diff[~noise[n]] <= 2e-5).all(), (n, diff.max())
            assert (diff[noise[n]] <= 2 * (step + 1) * 1e-3).all(), (n, diff.max())


def test_trainer_refuses_what_is_not_ported():
    m = torch.nn.Linear(2, 2)
    args = (lambda *a: None, lambda *a: None)
    for kw, cfg in ((dict(frozen={}), ttrainer.TrainConfig()),
                    (dict(has_batch_stats=True), ttrainer.TrainConfig()),
                    ({}, ttrainer.TrainConfig(remat=True)),
                    ({}, ttrainer.TrainConfig(mesh_shape=(2, 1, 1)))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrainer.Trainer(*args, cfg, m, lambda *a: None, device="cpu", **kw)


# -- (f) data pipeline -----------------------------------------------------------


def _write_pngs(root, rng, n=5, size=(40, 36)):
    clean_dir, noisy_dir = root / "clean", root / "noisy"
    clean_dir.mkdir()
    noisy_dir.mkdir()
    prefixes = ["", "Gauss_", "noisy_", "speckle_", "gauss_"]
    for i in range(n):
        a = (rng.random(size[::-1]) * 255).astype(np.uint8)
        Image.fromarray(a).save(clean_dir / f"img{i}.png")
        Image.fromarray(255 - a).save(noisy_dir / f"{prefixes[i % 5]}img{i}.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(clean_dir / "orphan.png")
    return str(clean_dir), str(noisy_dir)


def test_paired_dataset_and_batches_match_jax(rng, tmp_path):
    clean_dir, noisy_dir = _write_pngs(tmp_path, rng)
    assert tdata.match_pairs(clean_dir, [noisy_dir]) == jdata.match_pairs(clean_dir, [noisy_dir])
    assert len(tdata.match_pairs(clean_dir, noisy_dir)) == 5
    for sub in (False, True):
        assert (tdata.match_pairs(clean_dir, [noisy_dir], 3, substring_glob=sub)
                == jdata.match_pairs(clean_dir, [noisy_dir], 3, substring_glob=sub))
    np.testing.assert_array_equal(tdata.load_image(os.path.join(clean_dir, "img0.png"), 32),
                                  jdata.load_image(os.path.join(clean_dir, "img0.png"), 32, use_native=False))
    tds = tdata.PairedXRayDataset(clean_dir, [noisy_dir], img_size=24, seed=5)
    jds = jdata.PairedXRayDataset(clean_dir, [noisy_dir], img_size=24, seed=5)
    assert len(tds) == len(jds) == 5
    for i in (0, 3, 3, 1):  # repeated index: the augmentation rng advances alike
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    tb = list(tdata.batches(tds, 2, seed=4))
    jb = list(jdata.batches(jds, 2, seed=4))
    assert len(tb) == len(jb) == 2
    for (tc, tn), (jc, jn) in zip(tb, jb):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("noise", ["gaussian", "speckle", "poisson"])
def test_synthetic_dataset_matches_jax(rng, noise):
    clean = rng.random((4, 20, 20, 1)).astype(np.float32)
    tds = tdata.SyntheticPairedDataset(clean, noise_type=noise, seed=9)
    jds = jdata.SyntheticPairedDataset(clean, noise_type=noise, seed=9)
    for i in range(4):
        for a, b in zip(tds[i], jds[i]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    ev_t = tdata.SyntheticPairedDataset(clean, noise_type=noise, is_train=False, seed=2)
    ev_j = jdata.SyntheticPairedDataset(clean, noise_type=noise, is_train=False, seed=2)
    np.testing.assert_array_equal(ev_t[1][1], ev_j[1][1])


def test_augment_pair_matches_jax(rng):
    clean, noisy = image(rng, 30, 30, 1), image(rng, 30, 30, 1)
    cfg_t = tdata.AugmentConfig(rotation_prob=1.0, flip_prob=1.0, vflip_prob=1.0, brightness_prob=1.0,
                                contrast_prob=1.0, noise_prob=1.0)
    cfg_j = jdata.AugmentConfig(**dataclasses.asdict(cfg_t))
    for seed in range(3):
        got = tdata.augment_pair(clean, noisy, cfg_t, np.random.default_rng(seed))
        want = jdata.augment_pair(clean, noisy, cfg_j, np.random.default_rng(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_prefetch_moves_nchw_batches_and_reraises(rng):
    ds = tdata.SyntheticPairedDataset(rng.random((6, 8, 8, 1)).astype(np.float32), is_train=False)
    host = list(tdata.batches(ds, 2, shuffle=False))
    dev = list(tdata.prefetch_to_device(iter(host), torch.device("cpu"), size=1))
    assert len(dev) == 3
    for (c, n), (tc, tn) in zip(host, dev):
        assert tc.shape == (2, 1, 8, 8) and tc.is_contiguous()
        np.testing.assert_array_equal(tc.permute(0, 2, 3, 1).numpy(), c)
        np.testing.assert_array_equal(tn.permute(0, 2, 3, 1).numpy(), n)

    def broken():
        yield host[0]
        raise OSError("unreadable image")

    it = tdata.prefetch_to_device(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)


# -- (g) checkpoints -------------------------------------------------------------


def _tiny_run(tmp_path, rng, epochs, resume=None):
    ds = tdata.SyntheticPairedDataset(rng.random((4, 16, 16, 1)).astype(np.float32),
                                      noise_type="gaussian", is_train=False)
    cfg = ttrainer.TrainConfig(epochs=epochs, batch_size=2, lr=1e-3, ckpt_dir=str(tmp_path),
                               ckpt_name="diffusion", num_workers=0)
    return trecipes.train_diffusion(ds, model_cfg=tcfg.DiffusionUNetConfig(**TINY),
                                    schedule_cfg=tcfg.ScheduleConfig(noise_steps=10), train_cfg=cfg,
                                    resume=resume, val_inference_steps=3, device="cpu")


def test_pth_save_resume_round_trip(rng, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    st = _tiny_run(tmp_path, rng, epochs=1)
    path = tmp_path / "diffusion.pth"
    ckpt = load_checkpoint(str(path))
    assert ckpt["epoch"] == 0 and ckpt["best_psnr"] == pytest.approx(st.best_psnr)
    assert ckpt["model_channels"] == 8 and tuple(ckpt["channel_mult"]) == (1, 2)
    assert ckpt["noise_steps"] == 10 and ckpt["losses"] == st.history["losses"]
    assert (tmp_path / "diffusion_training_curves.png").exists()

    cfg = ttrainer.TrainConfig(epochs=2, ckpt_dir=str(tmp_path), ckpt_name="diffusion")
    sched = make_schedule(tcfg.ScheduleConfig(noise_steps=10))
    fresh = ttrainer.Trainer(ttrainer.diffusion_loss_fn(sched), lambda *a: None, cfg,
                             UNetDiffusion(tcfg.DiffusionUNetConfig(**TINY)),
                             ttrainer.diffusion_draw(sched), device="cpu")
    fresh.resume(str(tmp_path / "diffusion"))  # the JAX package's suffix-less path
    assert fresh.state.epoch == 1 and fresh.state.best_psnr == pytest.approx(st.best_psnr)
    assert fresh.state.history == st.history
    for k, v in st.model.state_dict().items():
        assert torch.equal(fresh.state.model.state_dict()[k], v), k
    saved = st.optimizer.state_dict()["state"]
    restored = fresh.state.optimizer.state_dict()["state"]
    assert saved.keys() == restored.keys()
    for i in saved:
        for k in saved[i]:
            assert torch.equal(saved[i][k], restored[i][k])

    # --resume continues at the next epoch and appends to the histories
    st2 = _tiny_run(tmp_path, rng, epochs=2, resume=str(path))
    assert len(st2.history["losses"]) == 2 and st2.history["losses"][0] == st.history["losses"][0]


def test_engine_serves_a_checkpoint_the_trainer_wrote(rng, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _tiny_run(tmp_path, rng, epochs=1)
    eng = InferenceEngine(EngineConfig(
        img_size=16, ckpt_dir=str(tmp_path), device="cpu", warmup=False,
        nafnet_cfg=tcfg.NAFNetConfig(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)),
        expert_cfg=tcfg.ExpertConfig(base_channels=8), router_cfg=tcfg.RouterConfig(base_c=8),
        fusion_cfg=tcfg.FusionConfig(base_c=16)))
    meta = eng.meta["diffusion"]
    assert "demo_weights" not in meta and meta["epoch"] == 0 and meta["noise_steps"] == 10
    out = eng.fns["diffusion"](image(rng, 1, 16, 16, 1))
    assert out.shape == (1, 16, 16, 1) and np.isfinite(out).all()
    eng.close()


# -- (h) the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("model", ["cddpm", "expert", "hybrid", "tiny"])
def test_cli_refuses_recipes_not_ported(model, capsys):
    with pytest.raises(SystemExit) as exc:
        trecipes.main(["--model", model, "--clear-dir", "c", "--noisy-dirs", "n"])
    assert exc.value.code != 0
    assert "ROADMAP.md queue 1 item 13" in capsys.readouterr().err


def test_cli_trains_the_tiny_preset(rng, tmp_path, monkeypatch):
    clean_dir, noisy_dir = _write_pngs(tmp_path, rng, n=2)
    monkeypatch.chdir(tmp_path)
    st = trecipes.main(["--model", "diffusion", "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
                        "--img-size", "16", "--epochs", "1", "--batch-size", "1", "--preset", "tiny",
                        "--device", "cpu"])
    assert len(st.history["losses"]) == 1 and np.isfinite(st.history["losses"][0])
    ckpt = load_checkpoint(str(tmp_path / "checkpoints" / "diffusion.pth"))
    assert ckpt["model_channels"] == 8 and ckpt["time_emb_dim"] == 16
