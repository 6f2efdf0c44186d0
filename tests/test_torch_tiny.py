"""The port's TinyUNet slice against the JAX package, on the CPU in fp32: the
TinyUNet forward, the 1000-step ``DDPMScheduler`` (its rollout fed the
normals JAX draws from its keys), ``edge_loss_xy`` and
``combined_loss_tiny``, one TinyUNet train step against the JAX train step,
the ``--model tiny`` CLI and the ``TinyUNetDenoiser`` on what it wrote."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu.diffusion import make_schedule as jmake_schedule
from midd_tpu.diffusion import noise_images as jnoise_images
from midd_tpu.diffusion.ddpm_scheduler import DDPMScheduler as JDDPMScheduler
from midd_tpu.models import TinyUNet as JTinyUNet
from midd_tpu.train import losses as jlosses
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.diffusion.ddpm_scheduler import DDPMScheduler, TinyUNetDenoiser
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.tiny_unet import TinyUNet
from midd_tpu_torch.train import losses as tlosses
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, port, rand

ATOL = 2e-4
NARROW = dict(base_ch=8, time_dim=16)  # the CLI's --preset tiny


def _pair(kw, size, rng):
    """A JAX TinyUNet with perturbed weights and the port's on them."""
    x = jnp.zeros((1, size, size, 1))
    jmodel = JTinyUNet(jcfg.TinyUNetConfig(**kw))
    variables = perturb(jax_init(jmodel, x, jnp.zeros((1,), jnp.int32), x), rng)
    return jmodel, variables, port(TinyUNet(tcfg.TinyUNetConfig(**kw)), variables)


# -- the TinyUNet ----------------------------------------------------------------


@pytest.mark.parametrize("kw,size", [(NARROW, 16), ({}, 32), (NARROW, 20)])
def test_tiny_unet_matches_jax(rng, kw, size):
    """Narrow and full width; 20² puts odd sizes through the ups' shape-fix."""
    jmodel, variables, tmodel = _pair(kw, size, rng)
    lat, cond = rand(rng, 2, size, size, 1), rand(rng, 2, size, size, 1)
    t = np.array([0, 917], np.int32)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(cond)))
    with torch.no_grad():
        got = nhwc(tmodel(nchw(lat), torch.from_numpy(t.astype(np.int64)), nchw(cond)))
    assert got.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tiny_unet_param_count_and_names():
    model = TinyUNet(tcfg.TINY_UNET)
    assert sum(p.numel() for p in model.parameters()) == 784_929  # modelfunctions.py:111
    keys = set(model.state_dict())
    for k in ("time_emb.0.weight", "time_emb.2.bias", "time_proj.weight", "inc.net.0.weight",
              "inc.net.1.weight", "inc.net.3.weight", "inc.net.4.bias", "down1.conv.net.0.weight",
              "up1.conv.net.4.weight", "outc.0.weight", "outc.2.bias"):
        assert k in keys, k


# -- the DDPM scheduler ------------------------------------------------------------


def test_ddpm_schedule_timesteps_and_add_noise(rng):
    js, ts = JDDPMScheduler(), DDPMScheduler()
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    for steps in (1, 12, 50, 1000, 7):
        assert ts.timesteps(steps) == np.asarray(js.timesteps(steps)).tolist()
    assert ts.timesteps(12) == [83 * i for i in range(11, -1, -1)]
    x0, noise = rand(rng, 3, 8, 8, 1), rand(rng, 3, 8, 8, 1)
    t = np.array([0, 499, 999])
    want = np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    got = nhwc(ts.add_noise(nchw(x0), nchw(noise), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("t", [996, 83, 0])
@pytest.mark.parametrize("with_noise", [False, True])
def test_ddpm_step_matches_jax(rng, t, with_noise):
    """One reverse step from a sample in [-1, 1], with x0 clipped (eps large
    enough to push it out); JAX's noise is its draw from the key."""
    js, ts = JDDPMScheduler(), DDPMScheduler()
    sample, eps = np.clip(rand(rng, 2, 8, 8, 1) * 0.5, -1, 1), rand(rng, 2, 8, 8, 1) * 2
    key = jax.random.PRNGKey(3) if with_noise else None
    want = np.asarray(js.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(sample), 12, key))
    noise = nchw(np.asarray(jax.random.normal(key, sample.shape, jnp.float32))) if with_noise else None
    got = nhwc(ts.step(nchw(eps), t, nchw(sample), 12, noise))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("stochastic", [False, True])
def test_ddpm_sample_matches_jax(rng, stochastic):
    """The 12-step rollout from the conditioning image on a narrow TinyUNet;
    JAX's noise rebuilt in numpy from its keys (``split(key, 12)[i]``) and
    fed to the port as ``noise_seq``."""
    jmodel, variables, tmodel = _pair(NARROW, 16, rng)
    cond = np.clip(rand(rng, 2, 16, 16, 1) * 0.5, -1, 1)
    key = jax.random.PRNGKey(0) if stochastic else None
    eps_j = lambda lat, t, c: jmodel.apply(variables, lat, t, c)
    want = np.asarray(jax.jit(lambda c: JDDPMScheduler().sample(eps_j, c, 12, key))(jnp.asarray(cond)))
    seq = None
    if stochastic:
        keys = jax.random.split(key, 12)
        seq = torch.stack([nchw(np.asarray(jax.random.normal(k, cond.shape, jnp.float32))) for k in keys])
    with torch.no_grad():
        got = nhwc(DDPMScheduler().sample(tmodel, nchw(cond), 12, noise_seq=seq))
    assert np.isfinite(got).all()
    # 12 steps, each one clipped x0 and a posterior mean in fp32
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_ddpm_sample_draws_one_normal_per_step_from_its_generator(rng):
    _, _, tmodel = _pair(NARROW, 16, rng)
    cond = nchw(rand(rng, 1, 16, 16, 1) * 0.3)
    gen = torch.Generator().manual_seed(2)
    seq = torch.stack([torch.randn(cond.shape, generator=gen) for _ in range(12)])
    with torch.no_grad():
        a = DDPMScheduler().sample(tmodel, cond, 12, generator=torch.Generator().manual_seed(2))
        b = DDPMScheduler().sample(tmodel, cond, 12, noise_seq=seq)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise_seq shape"):
        DDPMScheduler().sample(tmodel, cond, 12, noise_seq=seq[:11])


# -- the losses -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["edge_loss_xy", "combined_loss_tiny"])
def test_tiny_losses_match_jax(rng, name):
    pred, target = rand(rng, 2, 24, 20, 1), rand(rng, 2, 24, 20, 1)
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target))))(jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    tv = tfn(tp, nchw(target))
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(nhwc(tp.grad), np.asarray(jg), atol=1e-4 * np.abs(np.asarray(jg)).max())


# -- one train step --------------------------------------------------------------------


def test_tiny_train_step_matches_the_jax_trainer(rng, tmp_path):
    """``tiny_loss_fn``/``tiny_draw`` against the JAX ``tiny_loss_fn`` and its
    train step, fed the t and eps that JAX draws from its key (t in
    [0, 1000), x_t on the 1000-step schedule, [-1, 1] data)."""
    size, b = 16, 2
    jmodel = JTinyUNet(jcfg.TinyUNetConfig(**NARROW))
    variables = perturb(jax_init(jmodel, jnp.zeros((1, size, size, 1)), jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, size, size, 1)), seed=3), rng)
    tmodel = port(TinyUNet(tcfg.TinyUNetConfig(**NARROW)), variables)
    jsched = jmake_schedule(jcfg.ScheduleConfig(noise_steps=1000))
    jloss_fn = jtrainer.tiny_loss_fn(jmodel, jsched)
    cfg_kw = dict(epochs=1, batch_size=b, lr=1e-3, ckpt_dir=str(tmp_path))
    jt = jtrainer.Trainer(jloss_fn, lambda *a: None, jtrainer.TrainConfig(**cfg_kw), variables["params"])
    draws = []
    tt = ttrainer.Trainer(ttrainer.tiny_loss_fn(), lambda *a: None, ttrainer.TrainConfig(**cfg_kw),
                          tmodel, draw_fn=lambda batch, gen: draws.pop(0), device="cpu")

    clean, noisy = image(rng, b, size, size, 1), image(rng, b, size, size, 1)
    jbatch, batch = (jnp.asarray(clean), jnp.asarray(noisy)), (nchw(clean), nchw(noisy))
    key = jax.random.PRNGKey(5)
    k_t, k_eps = jax.random.split(key)  # the JAX loss's own draws (trainer.py:222-224)
    t = jax.random.randint(k_t, (b,), 0, 1000)
    x_t, eps = jnoise_images(jbatch[0] * 2.0 - 1.0, t, jsched, k_eps)
    draw = (torch.from_numpy(np.array(t)).long(), nchw(np.array(x_t)), nchw(np.array(eps)))

    (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(jt.state.params, jbatch, key)
    tl, _ = ttrainer.tiny_loss_fn()(tmodel, batch, draw)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    jgrads = {k: v.numpy() for k, v in
              state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg)}).items()}
    top = max(np.abs(g).max() for g in jgrads.values())
    noise = {}
    for name, p in tmodel.named_parameters():
        g, tg = jgrads[name], p.grad.numpy()
        # Entries zero in exact arithmetic (the conv biases in front of a
        # GroupNorm with one channel per group, at base_ch 8) are rounding
        # noise on both sides: below 1e-6 of the largest gradient on both.
        # The others as the diffusion step is held (test_torch_train.py).
        noise[name] = np.abs(g) < 1e-6 * top
        assert (np.abs(tg[noise[name]]) < 1e-6 * top).all(), name
        np.testing.assert_allclose(tg[~noise[name]], g[~noise[name]], rtol=1e-3,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-3 * top), err_msg=name)

    draws.append(draw)
    tloss = tt.train_step(batch)
    params, _, jloss = jt._train_step(jt.state.params, jt.state.opt_state, jbatch, key)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params)})
    for name, v in tmodel.state_dict().items():
        # one Adam step of size ~lr = 1e-3 from the same weights and
        # gradients; a noise entry only within Adam's step bound, as
        # test_torch_train.py holds them
        diff = np.abs(v.numpy() - want[name].numpy())
        assert (diff[~noise[name]] <= 2e-5).all(), (name, diff.max())
        assert (diff[noise[name]] <= 2e-3).all(), (name, diff.max())


def test_tiny_draw_follows_the_jax_formulas(rng):
    """t uniform over [0, 1000) and x_t = sqrt(ah) (2 clean - 1) + sqrt(1 - ah) eps."""
    sched = make_schedule(tcfg.ScheduleConfig(noise_steps=1000))
    clean = nchw(image(rng, 4096, 1, 1, 1))
    t, x_t, eps = ttrainer.tiny_draw(sched)((clean, clean), torch.Generator().manual_seed(0))
    assert t.min() == 0 and t.max() == 999 and len(torch.unique(t)) > 950
    ah = sched.alpha_hat[t][:, None, None, None]
    torch.testing.assert_close(x_t, torch.sqrt(ah) * (clean * 2 - 1) + torch.sqrt(1 - ah) * eps)


# -- the CLI and the denoiser -------------------------------------------------------------


def test_cli_trains_tiny_and_the_denoiser_runs_it(rng, tmp_path, monkeypatch):
    dirs = [tmp_path / "clean", tmp_path / "noisy"]
    for d in dirs:
        d.mkdir()
    for i in range(4):
        a = (rng.random((16, 16)) * 255).astype(np.uint8)
        Image.fromarray(a).save(dirs[0] / f"img{i}.png")
        Image.fromarray(255 - a).save(dirs[1] / f"img{i}.png")
    monkeypatch.chdir(tmp_path)
    st = trecipes.main(["--model", "tiny", "--clear-dir", str(dirs[0]), "--noisy-dirs", str(dirs[1]),
                        "--img-size", "16", "--epochs", "1", "--preset", "tiny", "--device", "cpu"])
    assert len(st.history["losses"]) == 1 and np.isfinite(st.history["losses"][0])
    ckpt = load_checkpoint(str(tmp_path / "checkpoints" / "tiny.pth"))
    assert (ckpt["in_ch"], ckpt["base_ch"], ckpt["time_dim"]) == (2, 8, 16)
    assert ckpt["epoch"] == 0 and "optimizer_state_dict" in ckpt
    with pytest.raises(SystemExit):
        trecipes.main(["--model", "tiny", "--clear-dir", str(dirs[0]), "--noisy-dirs", str(dirs[1]),
                       "--resume", "x.pth", "--device", "cpu"])

    den = TinyUNetDenoiser(ckpt["model_state_dict"], TinyUNet(tcfg.TinyUNetConfig(**NARROW)),
                           img_size=16, device="cpu")
    buf = io.BytesIO()
    Image.fromarray((rng.random((40, 30)) * 255).astype(np.uint8)).save(buf, format="PNG")
    out = den.denoise(buf.getvalue())
    assert out.mode == "L" and out.size == (16, 16)
    # seeded 0 by default, as JAX's PRNGKey(0): the same image twice
    assert np.array_equal(np.asarray(out), np.asarray(den.denoise(buf.getvalue())))
