"""``TrainConfig.remat`` of the port against its plain step and the JAX
package's ``TrainConfig(remat=True)`` step, on the CPU in fp32: the tiny
diffusion UNet (plain flash attention, fed the JAX step's draws) and the
tiny expert (train-mode BatchNorm, whose buffers must move once a step
although the forward runs twice)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.diffusion import make_schedule as jmake_schedule
from midd_tpu.diffusion import noise_images as jnoise_images
from midd_tpu.diffusion import sample_timesteps as jsample_timesteps
from midd_tpu.train import trainer as jtrainer
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.train import recipes as trecipes
from tests import _torch_dp_worker as worker
from tests.torch_port_util import assert_step_matches, image, jax_init, nchw, perturb, rand

SIZE, BATCH, LR, WD = 16, 4, 1e-3, 1e-4
JAX_MODELS = {"diffusion": lambda: jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**trecipes.TINY_UNET)),
              "expert": lambda: jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=8))}


def _port_step(name, job, remat):
    """One step of the port's trainer; the first convolution's forward calls."""
    trainer = worker._trainer(name, job, "unused", job[name].get("draw"), mesh_shape=None, remat=remat)
    model = trainer.state.model
    first = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    calls = []
    first.register_forward_hook(lambda *a: calls.append(1))
    out = worker._record(trainer, trainer.train_step((job[name]["clean"], job[name]["noisy"])))
    return out, len(calls)


@pytest.mark.parametrize("name", ["diffusion", "expert"])
def test_remat_step_equals_the_plain_step_and_the_jax_remat_step(rng, name):
    jmodel = JAX_MODELS[name]()
    x = jnp.zeros((1, SIZE, SIZE, 1))
    args = (x, x, jnp.zeros((1,), jnp.int32)) if name == "diffusion" else (x,)
    variables = perturb(jax_init(jmodel, *args, seed=3), rng)
    clean = image(rng, BATCH, SIZE, SIZE, 1)
    noisy = np.clip(clean + 0.1 * rand(rng, BATCH, SIZE, SIZE, 1), 0, 1).astype(np.float32)
    batch = (jnp.asarray(clean), jnp.asarray(noisy))
    key = jax.random.PRNGKey(9)
    job = {"batch": BATCH, "weight_decay": WD,
           name: {"state": state_dict_from_jax(variables), "clean": nchw(clean), "noisy": nchw(noisy)}}
    cfg = jtrainer.TrainConfig(epochs=1, batch_size=BATCH, lr=LR, weight_decay=WD, remat=True)
    if name == "diffusion":
        jsched = jmake_schedule(jcfg.SERVE_SCHEDULE)
        k_t, k_eps = jax.random.split(key)  # the JAX loss's own draws (trainer.py:203-206)
        t = jsample_timesteps(k_t, BATCH, jsched.noise_steps)
        x_t, eps = jnoise_images(batch[0], t, jsched, k_eps)
        job[name]["draw"] = (torch.from_numpy(np.array(t)).long(), nchw(np.array(x_t)), nchw(np.array(eps)))
        jt = jtrainer.Trainer(jtrainer.diffusion_loss_fn(jmodel, jsched), lambda *a: None, cfg, variables["params"])
        new, _, jloss = jt._train_step(jt.state.params, jt.state.opt_state, batch, key)
        tree = {"params": new}
    else:
        jt = jtrainer.Trainer(jtrainer.expert_loss_fn(jmodel), lambda *a: None, cfg, variables["params"],
                              extra={"batch_stats": variables["batch_stats"]}, has_batch_stats=True)
        new, _, stats, jloss = jt._train_step(jt.state.params, jt.state.opt_state, variables["batch_stats"],
                                              batch, key)
        tree = {"params": new, "batch_stats": stats}

    plain, plain_calls = _port_step(name, job, remat=False)
    remat, remat_calls = _port_step(name, job, remat=True)
    assert (plain_calls, remat_calls) == (1, 2)  # the backward ran the forward again
    # the same operations on the same inputs on the CPU: the same bits,
    # the BatchNorm buffers (moved once) and their counter included
    assert remat["loss"] == plain["loss"]
    for k, v in plain["state"].items():
        assert torch.equal(remat["state"][k], v), k
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    want = {"loss": float(jloss), "state": state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))}
    assert_step_matches(remat, want, f"{name} remat vs JAX remat", plain["grads"], LR)
