"""The traced rollout of the port's sampler, as a pinned program holds it:
``torch.export`` of ``denoise`` unrolls its Python loop over the scan steps,
one UNet eval per fresh step and none per reuse step. Export only, no
AOTInductor compile (``tests/test_torch_compile_cache.py`` and
``tests/test_torch_aot_configs.py`` compile the engine's programs).

(a) The exported rollout, run through ``ExportedProgram.module()``, against
    JAX's ``denoise`` (``lax.scan`` with ``lax.cond``) in fp32 on a tiny
    UNet with JAX-initialised weights, for refresh forms that take distinct
    paths: an index set, a mask without step 0 (zeros are reused first), and
    the ancestral update with ``noise_seq``; tolerance 1e-3, as
    ``tests/test_torch_sampler.py::test_denoise_matches_jax`` (each of the 9
    clamped steps amplifies the last rounding by up to 1/sqrt(alpha)).
(b) The exported ``diffusion`` and ``turbo@diffusion`` pins of a ``_small``
    engine hold one UNet's convolutions a fresh step, and compute the eager
    paths.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu.diffusion import sampler as jsampler
from midd_tpu.diffusion import schedule as jschedule
from midd_tpu_torch.diffusion import sampler as tsampler
from midd_tpu_torch.diffusion import schedule as tschedule
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from midd_tpu_torch.utils import compile_cache as cc
from tests._torch_aot_worker import SMALL
from tests.test_torch_sampler import unet_pair  # noqa: F401 - the module's fixture
from tests.torch_port_util import image, nchw, nhwc

ATOL = 1e-3
N_SCAN = 9  # timestep_sequence(50, 8)


def convolutions(program) -> int:
    """Convolution nodes (``aten.conv2d`` or ``aten.convolution``) over an
    exported program's graph and its subgraphs."""
    ops = (torch.ops.aten.conv2d.default, torch.ops.aten.convolution.default)
    return sum(node.op == "call_function" and node.target in ops
               for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
               for node in gm.graph.nodes)


class Rollout(torch.nn.Module):
    def __init__(self, unet, **kw):
        super().__init__()
        self.unet, self.kw = unet, kw

    def forward(self, x, *noise_seq):
        kw = dict(self.kw, **({"noise_seq": noise_seq[0]} if noise_seq else {}))
        return tsampler.denoise(self.unet, x, tschedule.make_schedule(), 8, **kw)


@pytest.fixture(scope="module")
def one_unet(unet_pair):  # noqa: F811
    x = torch.zeros((2, 1, 16, 16))
    return convolutions(cc.export(unet_pair[2], (x, x, torch.zeros((2,), dtype=torch.int64))))


MASK = np.array([i in (2, 5, 7) for i in range(N_SCAN)])


@pytest.mark.parametrize("eps_kw", [
    {"eps_refresh_idx": (0, 2, 6, 7)},
    {"eps_refresh_idx": MASK},
    {"stochastic": True, "eps_reuse": 2, "clamp_eps": False},
], ids=["studied", "mask_without_0", "noise_seq"])
def test_traced_rollout_matches_jax_scan(unet_pair, one_unet, eps_kw):  # noqa: F811
    jmodel, variables, tmodel = unet_pair
    rng = np.random.default_rng(5)
    noisy = image(rng, 2, 16, 16, 1)
    noise = rng.standard_normal((N_SCAN, 2, 16, 16, 1)).astype(np.float32) if eps_kw.get("stochastic") else None
    jkw = dict(eps_kw, **({"noise_seq": jnp.asarray(noise)} if noise is not None else {}))
    if isinstance(jkw.get("eps_refresh_idx"), np.ndarray):
        jkw["eps_refresh_idx"] = jnp.asarray(jkw["eps_refresh_idx"])
    run = jax.jit(partial(jsampler.denoise, lambda x, c, t: jmodel.apply(variables, x, c, t),
                          schedule=jschedule.make_schedule(jcfg.ScheduleConfig()), inference_steps=8, **jkw))
    want = np.asarray(run(jnp.asarray(noisy)))

    args = (nchw(noisy),) + ((torch.from_numpy(noise).permute(0, 1, 4, 2, 3).contiguous(),)
                             if noise is not None else ())
    program = cc.export(Rollout(tmodel, **eps_kw), args)
    fresh = tsampler.refresh_steps(N_SCAN, eps_kw.get("eps_reuse", 1), eps_kw.get("eps_refresh_idx"))
    assert convolutions(program) == len(fresh) * one_unet  # a reuse step evaluates nothing
    with torch.no_grad():
        got = program.module()(*args)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL)


@pytest.fixture(scope="module")
def small_engine():
    engine = InferenceEngine(EngineConfig(**{**SMALL, "ckpt_dir": "/nonexistent", "adaptive_turbo": True}))
    yield engine
    engine.close()


@pytest.mark.parametrize("name", ["diffusion", "turbo@diffusion"])
def test_rollout_pin_holds_one_unet_a_fresh_step(small_engine, name):
    """The pin holds as many UNets as the eager path evaluates (SMALL: 2 on
    the path, 1 on its turbo tier), and computes what it computes."""
    module, (flats, x) = small_engine._pinned(name, 2)
    x = torch.from_numpy(np.random.default_rng(2).random(x.shape, dtype=np.float32))
    program = cc.export(module, (flats, x))
    unet = small_engine.replicas[0]["unet_eval"]
    one = convolutions(cc.export(unet, (x, x, torch.zeros((2,), dtype=torch.int64))))
    table = small_engine._turbo_paths if name.startswith("turbo@") else small_engine._paths
    evals = []
    hook = unet.register_forward_hook(lambda *_: evals.append(1))
    try:
        with torch.no_grad():
            want = table["diffusion"](x)
    finally:
        hook.remove()
    assert one > 0 and evals and convolutions(program) == len(evals) * one
    with torch.no_grad():
        got = program.module()(flats, x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
