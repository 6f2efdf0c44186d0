"""Shared helpers of the ``test_torch_*`` parity tests: initialise a JAX
model, carry its variables into the port with ``state_dict_from_jax``, and
move NHWC numpy arrays to NCHW torch tensors and back."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from midd_tpu_torch.convert.from_jax import state_dict_from_jax


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init(model, *args, seed: int = 0):
    """``model.init`` on the given inputs, as a numpy tree."""
    return to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(seed), *args))


def jax_apply(model, variables, *args) -> np.ndarray:
    return np.asarray(jax.jit(model.apply)(variables, *args))


def perturb(variables, rng: np.random.Generator):
    """Give every bias, norm scale, NAFBlock beta/gamma and BatchNorm
    statistic a random value, so that none of them is a no-op."""

    def visit(path, leaf):
        name = path[-1].key
        if name in ("bias", "beta", "gamma", "mean"):
            return (0.2 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, variables)


def port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX ``variables`` into a port module (strict) and set eval mode."""
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def rand(rng: np.random.Generator, *shape) -> np.ndarray:
    return rng.standard_normal(shape, dtype=np.float32)


def image(rng: np.random.Generator, *shape) -> np.ndarray:
    return np.clip(0.5 + 0.2 * rand(rng, *shape), 0.0, 1.0).astype(np.float32)


def write_router_fusion_hybrid(port_dir: str, jax_dir: str, rng: np.random.Generator,
                               router_cfg, fusion_cfg, size: int = 32) -> None:
    """A trainer-style hybrid checkpoint, router and fusion weights only, in
    two forms with the same weights: ``hybrid.pth`` in ``port_dir`` and an
    orbax ``hybrid/`` in ``jax_dir`` (the JAX engine's ``.pth`` reader
    converts all four groups of a hybrid and refuses a file without its
    backends)."""
    import os

    import jax.numpy as jnp

    from midd_tpu import models as jm
    from midd_tpu.utils.checkpoint import save_checkpoint

    x = jnp.zeros((1, size, size, 1))
    router = perturb(jax_init(jm.NoiseAnalyzer(router_cfg), x, seed=int(rng.integers(1 << 30))), rng)
    ins = (x,) * (4 if fusion_cfg.sees_expert else 3)
    fusion = perturb(jax_init(jm.FusionModule(fusion_cfg), *ins, seed=int(rng.integers(1 << 30))), rng)
    sd = {f"{prefix}.{k}": v for prefix, tree in (("router", router), ("fusion", fusion))
          for k, v in state_dict_from_jax(tree).items()}
    torch.save({"model_state_dict": sd, "epoch": 1}, os.path.join(port_dir, "hybrid.pth"))
    save_checkpoint(os.path.join(jax_dir, "hybrid"),
                    {"params": {"router": router["params"], "fusion": fusion["params"]}}, {})


def assert_step_matches(got, want, name, grads, lr):
    """One train step from the same weights, ``got`` against ``want`` (each
    {"loss", "state"[, "grads"]}, the state a state_dict): the loss to
    1e-5, the BatchNorm statistics to 1e-5, and each parameter to 2e-5,
    except at most 2% of
    the entries, whose gradient (in ``grads``, the single-process step's
    clipped gradients) is under 1e-3 of its tensor's largest (floored at
    1e-3 of the model's largest): Adam's first step (~ lr * g / |g|) turns
    their rounding into a move anywhere in +-lr, so they are held to 2 lr
    (as tests/test_torch_expert_train.py). ``want["grads"]``, where given:
    each clipped gradient to 1e-4 of that scale."""
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), name
    top = max(g.abs().max().item() for g in grads.values())
    n_loose = n_all = 0
    for k, g in grads.items():
        g = g.numpy()
        scale = max(np.abs(g).max(), 1e-3 * top)
        if "grads" in want:
            np.testing.assert_allclose(got["grads"][k].numpy(), want["grads"][k].numpy(), rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=f"{name} {k}")
        diff = np.abs(got["state"][k].numpy() - want["state"][k].numpy())
        loose = diff > 2e-5
        assert (np.abs(g[loose]) < 1e-3 * scale).all(), (name, k, diff[loose].max())
        assert (diff <= 2 * lr).all(), (name, k, diff.max())
        n_loose, n_all = n_loose + int(loose.sum()), n_all + loose.size
    assert n_loose <= 0.02 * n_all, (name, n_loose, n_all)
    for k, w in want["state"].items():
        if k.endswith(("running_mean", "running_var")):
            w = w.numpy()
            np.testing.assert_allclose(got["state"][k].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")
        elif k.endswith("num_batches_tracked"):
            assert int(got["state"][k]) == 1, (name, k)  # the port's counter (JAX keeps none)
