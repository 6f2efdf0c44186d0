"""The port's expert training slice against the JAX package, on the CPU in
fp32: BatchNorm in train mode (the output and the running statistics that
flax's ``nn.BatchNorm`` keeps), the expert losses and the differentiable
SSIM, two train steps of the expert ``Trainer`` against the JAX train step
from the same weights and batches (parameters, Adam moments and batch
statistics), a non-finite batch, ``init_from``, and the ``--model expert``
CLI writing an ``expert.pth`` that the port's engine serves."""

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
from midd_tpu_torch.models.direct_unet import ExpertDenoiser
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.train import data as tdata
from midd_tpu_torch.train import losses as tlosses
from midd_tpu_torch.train import recipes as trecipes
from midd_tpu_torch.train import trainer as ttrainer
from midd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, port, rand

BASE = 8  # the CLI's tiny preset: ExpertConfig(base_channels=8)
SIZE, BATCH = 16, 2  # the bottleneck sees 4x4 x 2 = 32 values a channel


def _jax_expert(seed=3, rng=None):
    jmodel = jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=BASE))
    variables = jax_init(jmodel, jnp.zeros((1, SIZE, SIZE, 1)), seed=seed)
    return jmodel, (perturb(variables, rng) if rng is not None else variables)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _running(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def _assert_stats_match(tmodel, batch_stats, rel=1e-5):
    """The port's running buffers against flax's batch_stats."""
    want = state_dict_from_jax({"batch_stats": _np_tree(batch_stats)})
    got = _running(tmodel)
    assert set(got) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=rel, atol=rel * np.abs(w).max(), err_msg=k)


# -- BatchNorm in train mode ------------------------------------------------------


def test_batchnorm_train_mode_matches_flax(rng):
    """Two train-mode forwards of the whole ExpertDenoiser: the output and
    the running statistics after each. The bottleneck's statistics come from
    32 values a channel, where torch's unbiased running variance would be
    32/31 of flax's biased one, 3% off; the bound is 1e-5."""
    jmodel, variables = _jax_expert(rng=rng)
    tmodel = port(ExpertDenoiser(tcfg.ExpertConfig(base_channels=BASE)), variables).train()
    params, stats = variables["params"], variables["batch_stats"]
    apply = jax.jit(lambda p, s, x: jmodel.apply({"params": p, "batch_stats": s}, x, train=True,
                                                 mutable=["batch_stats"]))
    for _ in range(2):
        x = image(rng, BATCH, SIZE, SIZE, 1)
        jout, mutated = apply(params, stats, jnp.asarray(x))
        stats = mutated["batch_stats"]
        tout = tmodel(nchw(x))
        # fp32 batch statistics summed in another order (~sqrt(n) 2^-24 of
        # E[x^2], amplified by mean^2 / var in the one-pass variance), through
        # 13 BatchNorms and 15 convolutions: 1e-4 of max|out| (measured 1.3e-5),
        # which a TF32 layer (2^-11) would not fit
        np.testing.assert_allclose(nhwc(tout), np.asarray(jout), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(jout)).max())
        _assert_stats_match(tmodel, stats)
    assert int(tmodel.inc[1].num_batches_tracked) == 2
    # eval mode then normalises with those running statistics, as flax's train=False
    x = image(rng, 1, SIZE, SIZE, 1)
    jeval = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        teval = tmodel.eval()(nchw(x))
    np.testing.assert_allclose(nhwc(teval), np.asarray(jeval), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jeval)).max())


# -- the expert losses and SSIM ---------------------------------------------------


def _grad_parity(jfn, tfn, pred, target):
    """Value and gradient (w.r.t. pred) of a loss on both sides."""
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target))))(jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    tv = tfn(tp, nchw(target))
    if not tv.requires_grad:  # a detached loss: no gradient reaches pred
        return float(jv), np.asarray(jg), float(tv), None
    tv.backward()
    return float(jv), np.asarray(jg), float(tv.detach()), nhwc(tp.grad)


LOSSES = {
    "feature_loss": (jlosses.feature_loss, tlosses.feature_loss),
    "ssim_loss": (jlosses.ssim_loss, tlosses.ssim_loss),
    "ssim_loss_dead_grad": (lambda p, t: jlosses.ssim_loss(p, t, dead_grad=True),
                            lambda p, t: tlosses.ssim_loss(p, t, dead_grad=True)),
    "hybrid_loss_expert_w0.3": (jlosses.hybrid_loss_expert, tlosses.hybrid_loss_expert),
    "hybrid_loss_expert_w0": (lambda p, t: jlosses.hybrid_loss_expert(p, t, perceptual_weight=0.0),
                              lambda p, t: tlosses.hybrid_loss_expert(p, t, perceptual_weight=0.0)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_expert_losses_match_jax(rng, name):
    # 22 x 18: the feature stack's 2x pools drop a ragged row and column
    pred, target = image(rng, 2, 22, 18, 1), image(rng, 2, 22, 18, 1)
    jv, jg, tv, tg = _grad_parity(*LOSSES[name], pred, target)
    # fp32 convolutions and window sums in another order
    assert tv == pytest.approx(jv, rel=1e-5)
    if name == "ssim_loss_dead_grad":
        assert not jg.any() and tg is None
    else:
        assert np.abs(tg).max() > 0
        np.testing.assert_allclose(tg, jg, atol=1e-4 * np.abs(jg).max())


def test_feature_params_are_the_jax_stack_in_oihw():
    jparams = jlosses._feature_params()
    tparams = tlosses._feature_params()
    assert [k.shape for k in tparams] == [(16, 1, 3, 3), (32, 16, 3, 3), (64, 32, 3, 3)]
    for j, t in zip(jparams, tparams):
        np.testing.assert_array_equal(t, np.transpose(j, (3, 2, 0, 1)))
    w = tlosses._feature_weights(torch.device("cpu"))
    assert w is tlosses._feature_weights(torch.device("cpu"))  # built once per device
    assert all(x.dtype == torch.float32 for x in w)


# -- the expert trainer -----------------------------------------------------------


def _find_adam(state):
    """optax's ScaleByAdamState (mu, nu) inside the JAX optimizer state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, (tuple, list)) or hasattr(state, "_fields"):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    if hasattr(state, "inner_state"):
        return _find_adam(state.inner_state)
    return None


def _jax_trainer(jmodel, params, batch_stats, tmp_path, variant, lr):
    cfg = jtrainer.TrainConfig(epochs=1, batch_size=BATCH, lr=lr, weight_decay=1e-5, ckpt_dir=str(tmp_path))
    return jtrainer.Trainer(jtrainer.expert_loss_fn(jmodel, loss_variant=variant), lambda *a: None, cfg,
                            params, extra={"batch_stats": batch_stats}, has_batch_stats=True)


def _trainers(rng, tmp_path, variant, lr=1e-3):
    jmodel, variables = _jax_expert(rng=rng)
    jt = _jax_trainer(jmodel, variables["params"], variables["batch_stats"], tmp_path, variant, lr)
    tmodel = port(ExpertDenoiser(tcfg.ExpertConfig(base_channels=BASE)), variables)
    cfg = ttrainer.TrainConfig(epochs=1, batch_size=BATCH, lr=lr, weight_decay=1e-5, ckpt_dir=str(tmp_path))
    tt = ttrainer.Trainer(ttrainer.expert_loss_fn(loss_variant=variant), lambda *a: None, cfg, tmodel,
                          ttrainer.no_draw, has_batch_stats=True, device="cpu")
    return jt, tt, tmodel, variables


def _pair(rng):
    clean = image(rng, BATCH, SIZE, SIZE, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
    return clean, noisy


def _sd(tree, collection="params"):
    return {k: v.numpy().astype(np.float64) for k, v in state_dict_from_jax({collection: _np_tree(tree)}).items()}


def _jax_state(params, opt_state, stats, start):
    """A JAX trainer's state as the port names it: each parameter's update
    since ``start``, both Adam moments, the running statistics."""
    adam = _find_adam(opt_state)
    p = _sd(params)
    return {"update": {n: v - start[n] for n, v in p.items()}, "mu": _sd(adam.mu), "nu": _sd(adam.nu),
            "stats": {n: v for n, v in _sd(stats, "batch_stats").items() if not n.endswith("num_batches_tracked")}}


def _port_state(tmodel, tt, start):
    opt = tt.state.optimizer.state
    named = list(tmodel.named_parameters())
    as64 = lambda t: t.detach().numpy().astype(np.float64)  # noqa: E731
    return {"update": {n: as64(p) - start[n] for n, p in named},
            "mu": {n: as64(opt[p]["exp_avg"]) for n, p in named},
            "nu": {n: as64(opt[p]["exp_avg_sq"]) for n, p in named},
            "stats": {n: as64(v) for n, v in _running(tmodel).items()}}


def _worst_rel_l2(got, want):
    """Per kind, the largest ||got - want|| / ||want|| over the tensors."""
    return {kind: max(np.linalg.norm(got[kind][n] - w) / max(np.linalg.norm(w), 1e-30)
                      for n, w in want[kind].items()) for kind in want}


# The second step starts from each trainer's own state, and the tiny model
# amplifies what the first step left: through 13 train-mode BatchNorms over
# 32-512 values a channel, three first-step entries whose gradients are
# rounding noise (Adam then moves them anywhere in +-lr) move the second
# step's gradients by ~1e-2 of their size. So in the second step every
# tensor is held in relative L2 to STEP2_SPREAD times the largest such
# spread of its kind between two JAX trainers, one of whose weights start
# one ulp up, measured in the same test: the port's own rounding differs
# from JAX's in every operation, not in the weights alone (measured at
# 0.48-1.03x that spread), and 10x leaves a margin over it, while a
# BatchNorm that kept torch's unbiased running variance (3% off) would move
# the statistics ~3000x their one-ulp spread of ~1e-5.
STEP2_SPREAD = 10.0


@pytest.mark.parametrize("variant", ["reference", "l2"])
def test_two_train_steps_match_the_jax_trainer(rng, tmp_path, variant):
    """Step 1 from the same weights, entry by entry: gradients, parameters,
    moments and statistics. Step 2 from each side's own state: the loss,
    and per tensor the update of each parameter over both steps, both
    moments and the statistics, against the one-ulp spread."""
    jt, tt, tmodel, variables = _trainers(rng, tmp_path, variant)
    jmodel = jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=BASE))
    jloss_fn = jtrainer.expert_loss_fn(jmodel, loss_variant=variant)
    ulp_params = jax.tree_util.tree_map(lambda a: np.nextafter(a, np.float32(np.inf)), _np_tree(jt.state.params))
    jt_ulp = _jax_trainer(jmodel, ulp_params, variables["batch_stats"], tmp_path / "ulp", variant, 1e-3)
    start, start_ulp = _sd(jt.state.params), _sd(ulp_params)
    state = [jt.state.params, jt.state.opt_state, variables["batch_stats"]]
    state_ulp = [jt_ulp.state.params, jt_ulp.state.opt_state, variables["batch_stats"]]
    key = jax.random.PRNGKey(0)

    clean, noisy = _pair(rng)
    jbatch = (jnp.asarray(clean), jnp.asarray(noisy))
    jg, _ = jax.jit(jax.grad(jloss_fn, has_aux=True))(state[0], jbatch, key, state[2])
    tloss = tt.train_step((nchw(clean), nchw(noisy)))
    *state, jloss = jt._train_step(*state, jbatch, key)
    *state_ulp, _ = jt_ulp._train_step(*state_ulp, jbatch, key)
    # fp32 on both sides, another summation order through ~30 layers
    assert tloss == pytest.approx(float(jloss), rel=1e-5)

    jgrads = {k: v.numpy() for k, v in state_dict_from_jax({"params": _np_tree(jg)}).items()}
    clip = min(1.0, 1.0 / np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in jgrads.values())))
    top = max(np.abs(g).max() for g in jgrads.values())
    noise = {}
    for n, p in tmodel.named_parameters():
        g = clip * jgrads[n]
        scale = max(np.abs(g).max(), 1e-3 * clip * top)
        # entries whose gradient is under 1e-3 of its scale (ten times its
        # bound below): there the gradients' rounding can turn Adam's first
        # normalised step (~ lr * g / |g|) anywhere in +-lr, so those entries
        # are held to that bound only, as in test_torch_train.py
        noise[n] = np.abs(g) < 1e-3 * scale
        # the train step's clipped gradients: 1e-4 of the largest entry,
        # floored at 1e-3 of the model's largest (test_torch_nafnet_train.py)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3, atol=1e-4 * scale, err_msg=n)
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert n_noise <= 0.02 * sum(m.size for m in noise.values()), n_noise
    want = _sd(state[0])
    for n, p in tmodel.named_parameters():
        # one Adam step of size ~lr = 1e-3 from the same weights
        diff = np.abs(p.detach().numpy() - want[n])
        assert (diff[~noise[n]] <= 2e-5).all(), (n, diff[~noise[n]].max())
        assert (diff[noise[n]] <= 2e-3).all(), (n, diff.max())  # +-lr on each side
    _assert_stats_match(tmodel, state[2])
    adam = _find_adam(state[1])
    mu, nu = _sd(adam.mu), _sd(adam.nu)
    for n, p in tmodel.named_parameters():
        st = tt.state.optimizer.state[p]
        # the first moment is 0.1 x the clipped gradient: its bound; the
        # second moment is 0.001 x its square: twice the relative bound
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[n], rtol=1e-3,
                                   atol=1e-4 * max(np.abs(mu[n]).max(), 1e-4 * clip * top), err_msg=n)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[n], rtol=2e-3,
                                   atol=2e-4 * max(np.abs(nu[n]).max(), 1e-9 * (clip * top) ** 2), err_msg=n)

    clean, noisy = _pair(rng)
    jbatch = (jnp.asarray(clean), jnp.asarray(noisy))
    tloss = tt.train_step((nchw(clean), nchw(noisy)))
    *state, jloss = jt._train_step(*state, jbatch, key)
    *state_ulp, jloss_ulp = jt_ulp._train_step(*state_ulp, jbatch, key)
    want = _jax_state(*state, start)
    port_spread = _worst_rel_l2(_port_state(tmodel, tt, start), want)
    port_spread["loss"] = abs(tloss - float(jloss)) / abs(float(jloss))
    ulp_spread = _worst_rel_l2(_jax_state(*state_ulp, start_ulp), want)
    ulp_spread["loss"] = abs(float(jloss_ulp) - float(jloss)) / abs(float(jloss))
    print(f"\nstep 2, {variant}: port {port_spread}\n  one ulp {ulp_spread}")
    for kind, spread in port_spread.items():
        assert ulp_spread[kind] > 0 and spread <= STEP2_SPREAD * ulp_spread[kind], (kind, port_spread, ulp_spread)


def test_nonfinite_batch_moves_the_statistics_but_not_the_parameters(rng, tmp_path):
    """A NaN in the target makes the loss NaN while the forward, on finite
    inputs, still moves the running statistics: JAX returns them whether or
    not the update was applied (trainer.py:365-372), and so does the port."""
    jt, tt, tmodel, variables = _trainers(rng, tmp_path, "reference")
    params, opt_state, stats = jt.state.params, jt.state.opt_state, variables["batch_stats"]
    clean, noisy = _pair(rng)
    clean[0, 3, 5, 0] = np.nan
    before_params = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    before_stats = _running(tmodel)
    tloss = tt.train_step((nchw(clean), nchw(noisy)))
    jparams, _, stats, jloss = jt._train_step(
        params, opt_state, stats, (jnp.asarray(clean), jnp.asarray(noisy)), jax.random.PRNGKey(0))
    assert np.isnan(tloss) and np.isnan(float(jloss))
    for n, p in tmodel.named_parameters():
        assert torch.equal(p.detach(), before_params[n]), n
    assert tt.state.optimizer.state == {} or all(
        int(s["step"]) == 0 for s in tt.state.optimizer.state.values())
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(variables["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    after = _running(tmodel)
    assert all(torch.isfinite(v).all() and not torch.equal(v, before_stats[k]) for k, v in after.items())
    _assert_stats_match(tmodel, stats)


@pytest.mark.parametrize("model, flag", [("expert", False), ("linear", True)])
def test_trainer_refuses_a_batch_stats_flag_the_model_contradicts(model, flag):
    """BatchNorm buffers move in every train-mode forward, so the flag must
    say whether the model has them."""
    m = ExpertDenoiser(tcfg.ExpertConfig(base_channels=BASE)) if model == "expert" else torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="BatchNorm statistics"):
        ttrainer.Trainer(lambda *a: None, lambda *a: None, ttrainer.TrainConfig(), m, ttrainer.no_draw,
                         has_batch_stats=flag, device="cpu")


def test_trainer_refuses_frozen_with_batch_stats():
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttrainer.Trainer(lambda *a: None, lambda *a: None, ttrainer.TrainConfig(), torch.nn.Linear(2, 2),
                         ttrainer.no_draw, has_batch_stats=True, frozen={}, device="cpu")


def test_init_from_carries_parameters_and_statistics(rng, tmp_path):
    model = ExpertDenoiser(tcfg.ExpertConfig(base_channels=BASE))
    _, variables = _jax_expert(rng=rng)
    model = port(model, variables)
    path = save_checkpoint(str(tmp_path / "src" / "expert.pth"), model.state_dict())
    ds = tdata.SyntheticPairedDataset(rng.random((2, SIZE, SIZE, 1)).astype(np.float32), is_train=False)
    cfg = ttrainer.TrainConfig(epochs=0, ckpt_dir=str(tmp_path / "fine"), ckpt_name="expert")
    fine = trecipes.train_expert(ds, model_cfg=tcfg.ExpertConfig(base_channels=BASE), train_cfg=cfg,
                                 init_from=path, device="cpu")
    assert fine.epoch == 0 and fine.optimizer.state_dict()["state"] == {}
    got = fine.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert any(k.endswith("running_var") and not torch.equal(v, torch.ones_like(v)) for k, v in got.items())


# -- the CLI ----------------------------------------------------------------------


def _write_pairs(root, rng, n=2, size=20):
    dirs = [root / "clean", root / "noisy"]
    for d in dirs:
        d.mkdir()
    for i in range(n):
        a = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(a).save(dirs[0] / f"img{i}.png")
        Image.fromarray(255 - a).save(dirs[1] / f"img{i}.png")
    return [str(d) for d in dirs]


def test_cli_trains_expert_and_the_engine_serves_it(rng, tmp_path, monkeypatch):
    clean_dir, noisy_dir = _write_pairs(tmp_path, rng)
    monkeypatch.chdir(tmp_path)
    st = trecipes.main(["--model", "expert", "--clear-dir", clean_dir, "--noisy-dirs", noisy_dir,
                        "--img-size", "16", "--epochs", "1", "--batch-size", "2", "--preset", "tiny",
                        "--device", "cpu"])
    assert len(st.history["losses"]) == 1 and np.isfinite(st.history["losses"][0])
    ckpt = load_checkpoint(str(tmp_path / "checkpoints" / "expert.pth"))
    assert ckpt["epoch"] == 0 and ckpt["base_channels"] == BASE and ckpt["in_channels"] == 1
    assert "optimizer_state_dict" in ckpt
    sd = ckpt["model_state_dict"]
    assert int(sd["inc.1.num_batches_tracked"]) == 1
    assert not torch.equal(sd["inc.1.running_var"], torch.ones(BASE))

    eng = InferenceEngine(EngineConfig(
        img_size=16, ckpt_dir=str(tmp_path / "checkpoints"), device="cpu", warmup=False,
        nafnet_cfg=trecipes.TINY_NAFNET, diffusion_cfg=tcfg.DiffusionUNetConfig(**trecipes.TINY_UNET),
        expert_cfg=trecipes.TINY_EXPERT, router_cfg=tcfg.RouterConfig(base_c=8),
        fusion_cfg=tcfg.FusionConfig(base_c=16)))
    try:
        meta = eng.meta["expert"]
        assert "demo_weights" not in meta and meta["epoch"] == 0 and meta["base_channels"] == BASE
        x = image(rng, 1, 16, 16, 1)
        out = eng.fns["expert"](x)
        with torch.no_grad():
            want = st.model.cpu().eval()(nchw(x)).clamp(0, 1)
        np.testing.assert_array_equal(out, nhwc(want))
    finally:
        eng.close()
