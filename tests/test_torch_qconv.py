"""The port's int8 convolutions (``midd_tpu_torch/ops/qconv.py``) and the
static-int8 engine against the JAX package's ``QuantConv``,
``calibrate_unet_rollout`` and int8 engine, on numpy-seeded inputs and
JAX-initialised weights.

On the CPU the integer product is the plain float64 one; the card's
``torch._int_mm`` form runs here too (this PyTorch build has it on the CPU)
and must agree with both it and XLA's int32 convolution bit for bit. The
card holds it against the plain version at the served shapes
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.diffusion import make_schedule as jax_make_schedule
from midd_tpu.models.blocks import tconv
from midd_tpu.ops import qconv as jq
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import qscales_from_jax, state_dict_from_jax
from midd_tpu_torch.diffusion.schedule import make_schedule
from midd_tpu_torch.models.blocks import with_compute_dtype
from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
from midd_tpu_torch.ops import qconv as tq
from midd_tpu_torch.serve import engine as engine_module
from midd_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from tests.test_torch_serve import UNET, _tiny, _write_checkpoints
from tests.torch_port_util import image, jax_apply, jax_init, nchw, nhwc, perturb, port, rand

STEPS, NOISE_STEPS = 3, 6


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quantconv_matches_jax(rng, mode, kernel, stride):
    x = rand(rng, 2, 16, 16, 8)
    params = perturb(jax_init(tconv(12, kernel, stride=stride), jnp.asarray(x), seed=1), rng)
    variables = dict(params)
    conv = tq.QuantConv2d(8, 12, kernel, stride=stride, mode=mode)
    conv.load_state_dict(state_dict_from_jax(params), strict=True)
    if mode == "static":
        _, mut = tconv(12, kernel, stride=stride, quant="calibrate").apply(
            params, jnp.asarray(x), mutable=["qscales"])
        variables["qscales"] = mut["qscales"]
        cal = tq.with_quant_mode(conv, "calibrate")
        with torch.no_grad():
            cal(nchw(x))
        assert cal.act_absmax.item() == float(mut["qscales"]["act_absmax"])
        tq.load_qscales(conv, qscales_from_jax(mut))
    want = np.asarray(tconv(12, kernel, stride=stride, quant=mode).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(conv(nchw(x)))
    # the same fp32 scales, roundings and integer sums on both sides
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

    # the integer product on the same int8 operands: XLA's int32 conv, the
    # plain float64 product and the card's _int_mm form agree bit for bit
    wf = conv.weight.detach().float()
    w_s = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
    wq = torch.round(wf / w_s[:, None, None, None]).to(torch.int8)
    xq = tq.quantize(nchw(x), torch.tensor(np.abs(x).max() / 127.0))
    pad = kernel // 2
    want_int = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(np.transpose(xq.numpy(), (0, 2, 3, 1))),
        jnp.asarray(np.transpose(wq.numpy(), (2, 3, 1, 0))),
        (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    plain = tq.int8_conv2d(xq, wq, stride, pad)  # CPU tensors: the plain version
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(np.transpose(plain.numpy(), (0, 2, 3, 1)), want_int)
    assert torch.equal(tq.int8_conv2d_int_mm(xq, wq, stride, pad), plain)


@pytest.mark.parametrize("shape", [(1, 5, 7, 3, 3, 2), (1, 48, 9, 48, 3, 2), (2, 12, 4, 10, 1, 1)])
def test_int_mm_form_pads_ragged_shapes(shape):
    """K, N not multiples of 8 and M under 16: the zero padding leaves the
    sums as they are."""
    b, c, h, o, k, s = shape
    g = torch.Generator().manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (b, c, h, h), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8)
    assert torch.equal(tq.int8_conv2d_int_mm(xq, wq, s, k // 2), tq.int8_conv2d_plain(xq, wq, s, k // 2))


def _unet_setup(rng):
    """Tiny-width UNets on both sides with the same perturbed weights, and
    calibration batches of noisy phantom-like images."""
    jmodel = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**UNET))
    x = image(rng, 2, 16, 16, 1)
    t = jnp.zeros((2,), jnp.int32)
    variables = perturb(jax_init(jmodel, jnp.asarray(x), jnp.asarray(x), t), rng)
    batches = [image(rng, 2, 16, 16, 1) for _ in range(2)]
    return variables, batches


def _jax_scales(variables, batches):
    cal = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**UNET), quant="calibrate")
    return jq.calibrate_unet_rollout(
        cal, {"params": variables["params"]}, jax_make_schedule(jcfg.ScheduleConfig(noise_steps=NOISE_STEPS)),
        batches, STEPS)


def _port_unet(variables, quant):
    return port(UNetDiffusion(tcfg.DiffusionUNetConfig(**UNET), quant=quant), variables)


def test_calibrated_scales_match_jax(rng):
    variables, batches = _unet_setup(rng)
    want = qscales_from_jax(_jax_scales(variables, batches))
    cal = tq.with_quant_mode(_port_unet(variables, "static"), "calibrate")
    got = tq.calibrate_unet_rollout(
        cal, make_schedule(tcfg.ScheduleConfig(noise_steps=NOISE_STEPS)), [nchw(b) for b in batches], STEPS)
    # 2 + 3 in the down ResBlocks, 1 downsampler, 2 x 2 mid, 4 x 3 up
    assert set(got) == set(want) and len(got) == 22
    for name in want:
        assert abs(got[name].item() - want[name].item()) <= 1e-5 * want[name].item(), name
    # a second pass starting from the first pass's scales keeps their max
    again = tq.calibrate_unet_rollout(
        tq.with_quant_mode(_port_unet(variables, "static"), "calibrate"),
        make_schedule(tcfg.ScheduleConfig(noise_steps=NOISE_STEPS)), [nchw(batches[0])], STEPS, scales=got)
    assert all(torch.equal(again[n], got[n]) for n in got)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quantized_unet_eval_matches_jax(rng, mode):
    """One int8 UNet eval, JAX's calibration carried across for static.
    The two sides' fp32 activations differ by summation order (~1e-7
    relative); where one sits on a rounding boundary of its int8 grid, one
    operand moves by one step, and that term of its conv by a_s * w_s * |wq|
    (under 1% of the conv's range), through the later layers. Measured
    here at ~1e-6 of max|eps|: 1e-4 holds a few such flips, while a wrong
    scale or rounding mode moves eps by whole percents."""
    variables, batches = _unet_setup(rng)
    x, cond = image(rng, 2, 16, 16, 1), image(rng, 2, 16, 16, 1)
    t = np.array([5, 2], np.int32)
    jvars = dict(variables)
    model = _port_unet(variables, mode)
    if mode == "static":
        jvars["qscales"] = _jax_scales(variables, batches)
        tq.load_qscales(model, qscales_from_jax(jvars["qscales"]))
    want = jax_apply(jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**UNET), quant=mode), jvars,
                     jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    with torch.no_grad():
        got = nhwc(model(nchw(x), nchw(cond), torch.from_numpy(t).long()))
    assert _max_rel(got, want) <= 1e-4
    # and the int8 eval is not the fp32 one
    fp32 = jax_apply(jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**UNET)), variables,
                     jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    assert _max_rel(got, fp32) > 1e-3


def test_quant_unet_keeps_the_parameters_and_fp32_int8_weights(rng):
    variables, _ = _unet_setup(rng)
    plain, q = _port_unet(variables, False), _port_unet(variables, "static")
    assert q.state_dict().keys() == plain.state_dict().keys()
    # in_conv, qkv/proj, the upsamplers and out_conv stay full precision
    names = {n for n, m in q.named_modules() if isinstance(m, tq.QuantConv2d)}
    assert "in_conv" not in names and not any("qkv" in n or "proj" in n or "out_conv" in n for n in names)
    assert "downs.1" in names  # the stride-2 downsampler
    bf16 = with_compute_dtype(q, torch.bfloat16)
    for name, mod in bf16.named_modules():
        if isinstance(mod, tq.QuantConv2d):
            assert mod.weight.dtype == torch.float32, name
        elif name == "in_conv":
            assert mod.weight.dtype == torch.bfloat16


def test_modes_and_scale_sets_raise_on_what_they_cannot_serve():
    with pytest.raises(ValueError, match="unknown int8 quant mode"):
        tq.quant_mode("staic")
    assert tq.quant_mode(True) == "dynamic"
    conv = tq.QuantConv2d(4, 6, 3, mode="static")
    with pytest.raises(ValueError, match="calibrate"):
        conv(torch.zeros(1, 4, 8, 8))
    with pytest.raises(KeyError, match="missing"):
        tq.load_qscales(conv, {})
    a, b = {"x": torch.tensor(1.0)}, {"x": torch.tensor(3.0)}
    assert tq.merge_qscales(a, b)["x"].item() == 3.0 and tq.merge_qscales(None, b) is b
    with pytest.raises(ValueError, match="quantize_int8"):
        InferenceEngine(EngineConfig(**_tiny(tcfg), quantize_int8="staic", device="cpu"))


def _same_int8_report(teng, jeng):
    got, want = teng.serving_mode(), jeng.serving_mode()
    for key in ("quantize_int8", "exact", "flash_attention"):
        assert got[key] == want[key], key
    assert got["exact"] is False


@pytest.mark.parametrize("quant", [True, "dynamic"])
def test_serving_mode_reports_int8_as_the_jax_engine(quant):
    """The report of a static engine is compared in the engine test below."""
    kw = {**_tiny(tcfg), "ckpt_dir": "/nonexistent", "turbo_eps_reuse": 1, "hybrid_turbo_eps_reuse": 1,
          "diffusion_eval_bf16": False, "hybrid_rollout_bf16": False}
    teng = InferenceEngine(EngineConfig(**kw, quantize_int8=quant, device="cpu"))
    jeng = JEngine(JEngineConfig(**{**kw, **_tiny(jcfg)}, quantize_int8=quant, persistent_cache=False))
    _same_int8_report(teng, jeng)
    assert teng.calibration_ms == {} and teng.int8_scales == {}


def test_static_int8_engine_matches_the_jax_engine(tmp_path, monkeypatch):
    """tests/test_qconv.py:87-121's config on the same .pth weights, fp32
    evals. The engines' startup calibrations agree to 1e-5 relative on
    every conv of both UNets (measured 4.3e-6). Their outputs agree as far
    as int8 rollouts can: the two sides' fp32 sums differ in the last bits,
    an activation on a rounding boundary of its int8 grid then moves by a
    whole step, and the 5 evals of the rollout compound it (measured, with
    JAX's scales served by both: max 0.026, mean 1.7e-3, corr 0.99992 at
    width 8). The bounds hold 2x that; a wrong rounding, scale or choice
    of quantised conv shows in the scale and eval checks above, which are
    exact to the last bits. Also tests/test_qconv.py's wiring check on the
    port's defaults (bf16 evals) against its fp32 engine."""
    rng = np.random.default_rng(3)
    _write_checkpoints(str(tmp_path), rng)
    kw = {**_tiny(tcfg), "diffusion_steps": 4, "hybrid_diffusion_steps": 4, "ckpt_dir": str(tmp_path)}
    fp32_evals = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False)
    jax_scales = []
    calibrate = JEngine._calibrate_unet

    def keep(self, *args):
        scales = calibrate(self, *args)
        jax_scales.append(qscales_from_jax(scales))
        return scales

    monkeypatch.setattr(JEngine, "_calibrate_unet", keep)
    jeng = JEngine(JEngineConfig(**{**kw, **_tiny(jcfg)}, **fp32_evals, quantize_int8="static",
                                 persistent_cache=False))
    teng = InferenceEngine(EngineConfig(**kw, **fp32_evals, quantize_int8="static", device="cpu"))
    _same_int8_report(teng, jeng)
    assert set(teng.calibration_ms) == {"diffusion", "hybrid"}
    assert len(jax_scales) == 2  # the hybrid's own UNet calibrates its own
    for name, want in zip(("diffusion", "hybrid"), jax_scales):
        got = teng.int8_scales[name]
        assert set(got) == set(want), name
        for conv in want:
            assert abs(got[conv].item() - want[conv].item()) <= 1e-5 * want[conv].item(), (name, conv)

    x = np.clip(rng.random((1, 32, 32, 1)), 0, 1).astype(np.float32)
    e_fp = InferenceEngine(EngineConfig(**kw, device="cpu"))
    e_q = InferenceEngine(EngineConfig(**kw, quantize_int8="static", device="cpu"))
    for name in ("diffusion", "hybrid"):
        yr, yq = e_fp.fns[name](x), e_q.fns[name](x)
        c = np.corrcoef(yr.ravel(), yq.ravel())[0, 1]
        assert c > 0.995, (name, c)
        assert np.abs(yq - yr).max() < 0.1, name

    # the port served with JAX's calibration
    carried = iter(jax_scales)
    monkeypatch.setattr(engine_module, "calibrate_unet_rollout", lambda *args: next(carried))
    teng = InferenceEngine(EngineConfig(**kw, **fp32_evals, quantize_int8="static", device="cpu"))
    for seed in range(2):
        x = np.clip(np.random.default_rng(seed).random((1, 32, 32, 1)), 0, 1).astype(np.float32)
        for name in ("diffusion", "hybrid"):
            got, want = teng.fns[name](x), np.asarray(jeng.fns[name](jnp.asarray(x)))
            assert np.abs(got - want).max() < 0.05, name
            assert np.abs(got - want).mean() < 4e-3, name
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9998, name


def test_int8_engine_fuses_and_batches_as_it_serves_per_path():
    """Static int8 under ``fused_request`` and ``batching``: the fused call
    and a batch of one compute what each path computes alone (the same
    modules, scales and inputs)."""
    kw = {**_tiny(tcfg), "ckpt_dir": "/nonexistent", "quantize_int8": "static", "device": "cpu"}
    x = image(np.random.default_rng(4), 1, 32, 32, 1)
    eng = InferenceEngine(EngineConfig(**kw, fused_request=True))
    try:
        fused = eng.fused(x)
        for name in ("diffusion", "nafnet", "expert", "hybrid"):
            np.testing.assert_array_equal(fused[name], eng.fns[name](x), err_msg=name)
    finally:
        eng.close()
    batched = InferenceEngine(EngineConfig(**kw, batching=True, batch_buckets=(1,)))
    try:
        outs = batched.batcher.process(x)
        for name in ("diffusion", "hybrid"):
            np.testing.assert_array_equal(outs[name], fused[name], err_msg=name)
    finally:
        batched.close()
