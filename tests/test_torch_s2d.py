"""The JAX engine's s2d layout flag in the port: ``EngineConfig.nafnet_s2d``
is accepted (a JAX engine config reads as it is) and changes nothing. The
JAX space-to-depth layouts are the same function on the same parameters,
restructured for the TPU's lanes; the port computes the plain layouts.

- ``serving_mode()``'s nested key set equals the JAX engine's under
  ``nafnet_s2d`` True/False x ``quantize_int8`` False/"dynamic", and so does
  every value but ``layout``, which reports the plain layouts the port
  computes where the JAX engine reports its restructurings;
- the port's outputs with ``nafnet_s2d=True`` are bit-equal to those with
  False, and agree with the JAX engine's s2d outputs on the same weights.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from tests.test_torch_serve import PLAIN_LAYOUT, _nested_keys, _tiny, _write_checkpoints
from tests.torch_port_util import image

# exact fp32 on both sides: every step of both rollouts fresh, fp32 evals
EXACT = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False,
             turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1)
# the NAFNet path is one forward: the suite's 2e-4 (tests/test_parity_torch.py:31)
# halved holds it (a few 1e-6 apart in practice). The rollout paths chain 9
# UNet evals through the posterior update, each eval's summation order apart
# from JAX's: the bound of the engine parity test (test_torch_serve.py).
BOUND = {"nafnet": 1e-4, "expert": 1e-4, "diffusion": 1e-3, "hybrid": 1e-3}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX engines built with the NAFNet s2d layout on, and with it off and
    per-call int8 on; the port's engines with the flag on and off; all on
    the same .pth files."""
    ckpt_dir = str(tmp_path_factory.mktemp("s2d"))
    _write_checkpoints(ckpt_dir, np.random.default_rng(23))
    jengs = {flags: JEngine(JEngineConfig(**_tiny(jcfg), **EXACT, ckpt_dir=ckpt_dir, nafnet_s2d=flags[0],
                                          quantize_int8=flags[1], persistent_cache=False))
             for flags in ((True, False), (False, "dynamic"))}
    ports = {flag: InferenceEngine(EngineConfig(**_tiny(tcfg), **EXACT, ckpt_dir=ckpt_dir,
                                                nafnet_s2d=flag, device="cpu"))
             for flag in (False, True)}
    yield jengs, ports, ckpt_dir
    for eng in ports.values():
        eng.close()


@pytest.mark.parametrize("quantize_int8", [False, "dynamic"])
@pytest.mark.parametrize("nafnet_s2d", [False, True])
def test_serving_mode_matches_the_jax_engine(engines, nafnet_s2d, quantize_int8):
    """Two of the four settings hold the port against a JAX engine built
    with them; those two set each flag both ways. The other two take the
    built engine of the same ``quantize_int8`` with its config's flags set:
    its ``serving_mode`` reads both flags from its config
    (``midd_tpu/serve/engine.py:1248,1262-1265``)."""
    jengs, _, ckpt_dir = engines
    flags = {"nafnet_s2d": nafnet_s2d, "quantize_int8": quantize_int8}
    teng = InferenceEngine(EngineConfig(**_tiny(tcfg), **EXACT, ckpt_dir=ckpt_dir, **flags,
                                        device="cpu"))
    jeng = jengs[(True, False) if not quantize_int8 else (False, "dynamic")]
    built = jeng.cfg
    jeng.cfg = dataclasses.replace(built, **flags)
    try:
        got, want = teng.serving_mode(), jeng.serving_mode()
        assert _nested_keys(got) == _nested_keys(want)
        for key in set(want) - {"layout"}:
            assert got[key] == want[key], key
        assert want["layout"] == {"nafnet_s2d": nafnet_s2d, "unet_fused_updown": True,
                                  "unet_s2d_stage0": not quantize_int8}
        assert got["layout"] == PLAIN_LAYOUT
    finally:
        jeng.cfg = built
        teng.close()


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_s2d_outputs_equal_plain_and_match_jax_s2d(engines, name):
    jengs, ports, _ = engines
    jeng = jengs[(True, False)]
    assert jeng.serving_mode()["layout"]["nafnet_s2d"] is True
    x = image(np.random.default_rng(7), 2, 32, 32, 1)
    on, off = ports[True].fns[name](x), ports[False].fns[name](x)
    assert on.shape == (2, 32, 32, 1)
    np.testing.assert_array_equal(on, off)
    want = np.asarray(jeng.fns[name](jnp.asarray(x)))
    np.testing.assert_allclose(on, want, atol=BOUND[name], err_msg=name)
