"""The port's cddpm slice against the JAX package, on the CPU in fp32: the
cddpm-mode UNet forward, the ancestral ``denoise`` on the same injected
noise (index sets and bool masks of refresh steps included),
``refresh_schedule`` in all four modes, one cddpm train step against the JAX
recipe's loss and train step, the ``--model cddpm`` CLI, and the port's
engine serving a cddpm checkpoint against JAX's deterministic rollout on the
same weights. The JAX UNet runs its plain attention (``use_flash=False``),
as its own CPU tests do."""

from functools import partial

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.diffusion import noise_images as jnoise_images
from midd_tpu.diffusion import sample_timesteps as jsample_timesteps
from midd_tpu.diffusion import sampler as jsampler
from midd_tpu.diffusion import schedule as jschedule
from midd_tpu.train import losses as jlosses
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.diffusion import sampler as tsampler
from midd_tpu_torch.diffusion import schedule as tschedule
from midd_tpu_torch.models import unet_diffusion as tunet
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import data as tdata
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, port, rand

# three levels and two ResBlocks a level, so that the cddpm ping-pong puts a
# skip at an upsampler's input resolution (the fused up/down fires)
CDDPM = dict(model_channels=8, channel_mult=(1, 2, 2), num_res_blocks=2,
             attention_resolutions=(1,), time_emb_dim=16, skip_mode="cddpm")
# the CLI's --preset tiny in cddpm mode
TINY_CDDPM = dict(trecipes.TINY_UNET, skip_mode="cddpm")
# test_torch_sampler.py's rollout bound: each step amplifies the previous
# rounding by up to 1/sqrt(alpha)
ROLLOUT_ATOL = 1e-3


@pytest.fixture(scope="module")
def cddpm_pair():
    rng = np.random.default_rng(7)
    x = jnp.zeros((1, 16, 16, 1))
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**CDDPM))
    variables = perturb(jax_init(jmodel, x, x, jnp.zeros((1,), jnp.int32)), rng)
    tmodel = port(tunet.UNetDiffusion(tcfg.DiffusionUNetConfig(**CDDPM)), variables)
    return jmodel, variables, tmodel


# -- the cddpm UNet ------------------------------------------------------------


@pytest.mark.parametrize("fuse_updown", [True, False])
def test_cddpm_unet_matches_jax(cddpm_pair, monkeypatch, fuse_updown):
    """Against the JAX default forward, which fuses the up/down pairs in
    cddpm mode too wherever that mode's ping-pong allows it."""
    jmodel, variables, _ = cddpm_pair
    rng = np.random.default_rng(3)
    x, cond = rand(rng, 2, 16, 16, 1) * 0.3, rand(rng, 2, 16, 16, 1) * 0.3
    t = np.array([7, 31], np.int32)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t)))
    ours = port(tunet.UNetDiffusion(tcfg.DiffusionUNetConfig(**CDDPM), fuse_updown=fuse_updown), variables)
    fused, plain = [], tunet.fused_updown

    def counting(up, a):
        fused.append(tuple(a.shape[-2:]))
        return plain(up, a)

    monkeypatch.setattr(tunet, "fused_updown", counting)
    with torch.no_grad():
        got = nhwc(ours(nchw(x), nchw(cond), torch.from_numpy(t.astype(np.int64))))
    assert bool(fused) == fuse_updown, fused
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_cddpm_unet_attention_blocks():
    """Attention after the first up-ResBlock of each attention resolution
    only: at CDDPM_UNET, 2 down + 1 mid + 1 up, against ddim's 6."""
    count = lambda cfg: sum(isinstance(m, tunet.AttentionBlock) for m in tunet.UNetDiffusion(cfg).modules())
    assert count(tcfg.CDDPM_UNET) == 4 and count(tcfg.SERVE_DIFFUSION) == 6
    _, ups, _ = tunet._build_specs(tcfg.DiffusionUNetConfig(**CDDPM))
    assert [k for k, _ in ups] == ["res", "res", "res", "up", "res", "attn", "res", "res", "up",
                                   "res", "res", "res"]
    with pytest.raises(ValueError, match="skip_mode"):
        tunet.UNetDiffusion(tcfg.DiffusionUNetConfig(skip_mode="ddpm"))


# -- the ancestral rollout -----------------------------------------------------


def _jax_rollout(jmodel, variables, noisy, steps, **kw):
    sched = jschedule.make_schedule(jcfg.ScheduleConfig())
    run = jax.jit(partial(jsampler.denoise, lambda x, c, t: jmodel.apply(variables, x, c, t),
                          schedule=sched, inference_steps=steps, **kw))
    return np.asarray(run(jnp.asarray(noisy)))


def _noise_seq(rng, n_steps, noisy):
    """(n_steps, *NHWC) standard normals for JAX and the same as NCHW."""
    seq = rand(rng, n_steps, *noisy.shape)
    return seq, torch.from_numpy(np.ascontiguousarray(seq.transpose(0, 1, 4, 2, 3)))


@pytest.mark.parametrize("steps,refresh", [
    (8, None), (50, None), (8, (0, 2, 6, 7)), (50, "mask"),
])
def test_stochastic_denoise_matches_jax(cddpm_pair, steps, refresh):
    jmodel, variables, tmodel = cddpm_pair
    rng = np.random.default_rng(11)
    noisy = image(rng, 2, 16, 16, 1)
    n_steps = len(tschedule.timestep_sequence(50, steps))
    seq, tseq = _noise_seq(rng, n_steps, noisy)
    kw = {}
    if refresh == "mask":
        mask = rng.random(n_steps) < 0.5
        mask[0] = True
        kw_j, kw = {"eps_refresh_idx": jnp.asarray(mask)}, {"eps_refresh_idx": mask.tolist()}
    elif refresh is not None:
        kw_j = kw = {"eps_refresh_idx": refresh}
    else:
        kw_j = {}
    want = _jax_rollout(jmodel, variables, noisy, steps, stochastic=True, clamp_eps=False,
                        noise_seq=jnp.asarray(seq), **kw_j)
    calls = []

    def eps_fn(x, c, t):
        calls.append(int(t[0]))
        return tmodel(x, c, t)

    with torch.no_grad():
        got = tsampler.denoise(eps_fn, nchw(noisy), tschedule.make_schedule(), steps,
                               stochastic=True, clamp_eps=False, noise_seq=tseq, **kw)
    assert len(calls) == len(tsampler.refresh_steps(n_steps, 1, kw.get("eps_refresh_idx")))
    assert got.shape == (2, 1, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=ROLLOUT_ATOL)


@pytest.mark.parametrize("as_type", [list, np.asarray, torch.tensor])
def test_refresh_mask_without_step_zero_matches_jax(cddpm_pair, as_type):
    """A bool mask, as a list, an array or a tensor: a step that reuses eps
    before any was computed reuses zeros, as in JAX."""
    jmodel, variables, tmodel = cddpm_pair
    noisy = image(np.random.default_rng(5), 1, 16, 16, 1)
    mask = [False, True, False, False, True, True, False, False, True]
    want = _jax_rollout(jmodel, variables, noisy, 8, eps_refresh_idx=jnp.asarray(mask))
    with torch.no_grad():
        got = tsampler.denoise(tmodel, nchw(noisy), tschedule.make_schedule(), 8,
                               eps_refresh_idx=as_type(mask))
    np.testing.assert_allclose(nhwc(got), want, atol=ROLLOUT_ATOL)
    assert tsampler.refresh_steps(9, 1, as_type(mask)) == {1, 4, 5, 8}


def test_denoise_draws_one_normal_per_step_from_its_generator(cddpm_pair):
    """A generator gives the rollout one standard normal of x's shape per
    scan step, t = 0 included: the same as those draws passed as noise_seq."""
    _, _, tmodel = cddpm_pair
    noisy = nchw(image(np.random.default_rng(9), 2, 16, 16, 1))
    gen = torch.Generator().manual_seed(4)
    seq = torch.stack([torch.randn(noisy.shape, generator=gen) for _ in range(9)])
    kw = dict(stochastic=True, clamp_eps=False)
    with torch.no_grad():
        a = tsampler.denoise(tmodel, noisy, tschedule.make_schedule(), 8,
                             generator=torch.Generator().manual_seed(4), **kw)
        b = tsampler.denoise(tmodel, noisy, tschedule.make_schedule(), 8, noise_seq=seq, **kw)
    assert torch.equal(a, b)


def test_denoise_errors_as_jax(cddpm_pair):
    jmodel, variables, tmodel = cddpm_pair
    noisy = image(np.random.default_rng(1), 1, 16, 16, 1)
    sched = tschedule.make_schedule()
    seq = torch.zeros(9, 1, 1, 16, 16)
    with pytest.raises(ValueError, match="stochastic sampling requires"):
        tsampler.denoise(tmodel, nchw(noisy), sched, 8, stochastic=True)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        _jax_rollout(jmodel, variables, noisy, 8, stochastic=True)
    with pytest.raises(ValueError, match="noise_seq requires stochastic=True"):
        tsampler.denoise(tmodel, nchw(noisy), sched, 8, noise_seq=seq)
    with pytest.raises(ValueError, match="noise_seq requires stochastic=True"):
        _jax_rollout(jmodel, variables, noisy, 8, noise_seq=jnp.zeros((9, 1, 16, 16, 1)))
    with pytest.raises(ValueError, match="noise_seq shape"):
        tsampler.denoise(tmodel, nchw(noisy), sched, 8, stochastic=True, noise_seq=seq[:8])
    msg = r"refresh mask shape \(8,\) != \(9,\) \(the ACTUAL rollout length"
    with pytest.raises(ValueError, match=msg):
        tsampler.denoise(tmodel, nchw(noisy), sched, 8, eps_refresh_idx=[True] * 8)
    with pytest.raises(ValueError, match=msg):
        _jax_rollout(jmodel, variables, noisy, 8, eps_refresh_idx=jnp.ones(8, bool))


# -- refresh_schedule ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["uniform", "last", "front", "tail"])
@pytest.mark.parametrize("n_steps", [9, 50])
def test_refresh_schedule_matches_jax(mode, n_steps):
    for n_evals in range(1, n_steps + 2):
        assert tsampler.refresh_schedule(n_steps, n_evals, mode) == \
            jsampler.refresh_schedule(n_steps, n_evals, mode), n_evals
    for fn in (tsampler.refresh_schedule, jsampler.refresh_schedule):
        with pytest.raises(ValueError, match="n_evals must be >= 1"):
            fn(n_steps, 0, mode)
        with pytest.raises(ValueError, match="unknown refresh mode 'middle'"):
            fn(n_steps, 3, "middle")


# -- one train step ----------------------------------------------------------------


def test_cddpm_train_step_matches_the_jax_recipe(rng, tmp_path):
    """The JAX recipe's loss (``train_cddpm``'s inner ``loss_fn``: plain MSE
    on eps from its own draws) and its train step, against the port's
    ``cddpm_loss_fn`` and Trainer fed the same draws."""
    size, b = 16, 2
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**TINY_CDDPM), use_flash=False)
    jsched = jschedule.make_schedule(jcfg.SERVE_SCHEDULE)
    x0 = jnp.zeros((1, size, size, 1))
    variables = perturb(jax_init(jmodel, x0, x0, jnp.zeros((1,), jnp.int32), seed=3), rng)

    def jloss_fn(p, batch, key):  # midd_tpu/train/recipes.py:185-191
        clean, noisy = batch
        k_t, k_eps = jax.random.split(key)
        t = jsample_timesteps(k_t, clean.shape[0], jsched.noise_steps)
        x_t, eps = jnoise_images(clean, t, jsched, k_eps)
        return jlosses.mse(jmodel.apply({"params": p}, x_t, noisy, t), eps), {}

    cfg_kw = dict(epochs=1, batch_size=b, lr=1e-3, ckpt_dir=str(tmp_path))
    jt = jtrainer.Trainer(jloss_fn, lambda *a: None, jtrainer.TrainConfig(**cfg_kw), variables["params"])
    tmodel = port(tunet.UNetDiffusion(tcfg.DiffusionUNetConfig(**TINY_CDDPM)), variables)
    draws = []
    tt = ttrainer.Trainer(ttrainer.cddpm_loss_fn(), lambda *a: None, ttrainer.TrainConfig(**cfg_kw),
                          tmodel, draw_fn=lambda batch, gen: draws.pop(0), device="cpu")

    clean, noisy = image(rng, b, size, size, 1), image(rng, b, size, size, 1)
    jbatch, batch = (jnp.asarray(clean), jnp.asarray(noisy)), (nchw(clean), nchw(noisy))
    key = jax.random.PRNGKey(5)
    k_t, k_eps = jax.random.split(key)
    t = jsample_timesteps(k_t, b, jsched.noise_steps)
    x_t, eps = jnoise_images(jbatch[0], t, jsched, k_eps)
    draw = (torch.from_numpy(np.array(t)).long(), nchw(np.array(x_t)), nchw(np.array(eps)))

    (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(jt.state.params, jbatch, key)
    tl, _ = ttrainer.cddpm_loss_fn()(tmodel, batch, draw)
    tl.backward()
    # fp32 on both sides, another summation order through ~30 layers
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    jgrads = {k: v.numpy() for k, v in
              state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg)}).items()}
    top = max(np.abs(g).max() for g in jgrads.values())
    noise = {}
    for name, p in tmodel.named_parameters():
        g, tg = jgrads[name], p.grad.numpy()
        # Entries zero in exact arithmetic (the key third of each qkv bias:
        # softmax ignores a shift common to all keys; the conv biases in
        # front of a GroupNorm with one channel per group, at these widths)
        # are rounding noise on both sides: below 1e-6 of the largest
        # gradient on both. The others to 1e-4 of their tensor's largest
        # entry, floored at 1e-3 of the model's largest, as the diffusion
        # step is held (test_torch_train.py).
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


# -- the CLI, the recipe's validation and the engine -------------------------------


def _write_pairs(root, rng, n=2, size=16):
    dirs = [root / "clean", root / "noisy"]
    for d in dirs:
        d.mkdir()
    for i in range(n):
        a = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(a).save(dirs[0] / f"img{i}.png")
        Image.fromarray(255 - a).save(dirs[1] / f"img{i}.png")
    return [str(d) for d in dirs]


def test_cddpm_validation_draws_afresh_from_seed_zero(rng, tmp_path):
    """At lr 0 the weights stay put, so two validations read the same PSNR
    only if each draws its posterior noise afresh from seed 0."""
    ds = tdata.SyntheticPairedDataset(rng.random((2, 16, 16, 1)).astype(np.float32), is_train=False)
    cfg = ttrainer.TrainConfig(epochs=2, batch_size=1, lr=0.0, weight_decay=0.0,
                               ckpt_dir=str(tmp_path), ckpt_name="cddpm")
    st = trecipes.train_cddpm(ds, model_cfg=tcfg.DiffusionUNetConfig(**TINY_CDDPM), train_cfg=cfg,
                              device="cpu")
    assert st.history["psnrs"][0] == st.history["psnrs"][1]
    assert np.isfinite(st.history["losses"]).all()


def test_cli_trains_cddpm_and_the_engine_serves_it_as_jax_does(rng, tmp_path, monkeypatch):
    from midd_tpu.convert.torch_import import convert_state_dict

    clean_dir, noisy_dir = _write_pairs(tmp_path, rng)
    monkeypatch.chdir(tmp_path)
    st = trecipes.main(["--model", "cddpm", "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
                        "--img-size", "16", "--epochs", "1", "--preset", "tiny", "--device", "cpu"])
    assert len(st.history["losses"]) == 1 and np.isfinite(st.history["losses"][0])
    ckpt_dir = tmp_path / "checkpoints"
    ckpt = load_checkpoint(str(ckpt_dir / "cddpm.pth"))
    assert ckpt["skip_mode"] == "cddpm" and ckpt["model_channels"] == 8 and ckpt["noise_steps"] == 50
    assert ckpt["epoch"] == 0 and "optimizer_state_dict" in ckpt

    # served as the diffusion model: the engine builds the cddpm UNet from the
    # metadata and rolls out deterministically (clamped eps), as JAX's does
    (ckpt_dir / "diffusion.pth").write_bytes((ckpt_dir / "cddpm.pth").read_bytes())
    eng = InferenceEngine(EngineConfig(
        img_size=16, ckpt_dir=str(ckpt_dir), device="cpu", warmup=False, diffusion_eval_bf16=False,
        nafnet_cfg=trecipes.TINY_NAFNET, expert_cfg=trecipes.TINY_EXPERT,
        router_cfg=tcfg.RouterConfig(base_c=8), fusion_cfg=tcfg.FusionConfig(base_c=16)))
    try:
        assert eng.meta["diffusion"]["skip_mode"] == "cddpm"
        assert eng.diffusion_eps_reuse == (0, 2, 6, 7)
        x = image(rng, 1, 16, 16, 1)
        got = eng.fns["diffusion"](x)
    finally:
        eng.close()
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**TINY_CDDPM))
    x0 = jnp.zeros((1, 16, 16, 1))
    target = jax_init(jmodel, x0, x0, jnp.zeros((1,), jnp.int32))
    variables = {"params": convert_state_dict(ckpt["model_state_dict"], target)["params"]}
    want = np.clip(_jax_rollout(jmodel, variables, x, 8, eps_refresh_idx=(0, 2, 6, 7)), 0, 1)
    np.testing.assert_allclose(got, want, atol=ROLLOUT_ATOL)
