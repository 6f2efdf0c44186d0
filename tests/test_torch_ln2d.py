"""The port's LayerNorm2d (``midd_tpu_torch/ops/ln2d.py`` and the module in
``models/blocks.py``) against the JAX package's: its Pallas ``ln2d_fused``
(interpret mode on the CPU, as tests/test_ln2d.py runs it) and its
``LayerNorm2d`` module. On the CPU the port runs the kernel's plain version;
the kernel itself is held against that on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu.models import blocks as jb
from midd_tpu.ops import ln2d as jln
from midd_tpu_torch.models import blocks as tb
from midd_tpu_torch.ops import ln2d as tln
from tests.torch_port_util import jax_init, nchw, nhwc, perturb, port


def _inputs(rng, shape, offset=1.0, spread=3.0):
    c = shape[-1]
    x = (rng.random(shape) * spread + offset).astype(np.float32)
    return x, rng.random(c).astype(np.float32), rng.random(c).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (1, 4, 4, 64), (1, 5, 3, 48),
                                   (2, 4, 4, 128), (2, 4, 2, 512)])
def test_ln2d_matches_jax_kernel(rng, shape):
    x, scale, bias = _inputs(rng, shape)
    want = np.asarray(jln.ln2d_fused(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = tln.ln2d_fused(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias))
    assert tln.supported(nchw(x))
    # fp32 sums over C in another order: the bound of tests/test_ln2d.py
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


def test_ln2d_bf16_matches_jax_kernel(rng):
    x, scale, bias = _inputs(rng, (2, 8, 8, 32), spread=2.0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jln.ln2d_fused(xb, jnp.asarray(scale), jnp.asarray(bias)).astype(jnp.float32))
    got = tln.ln2d_fused(nchw(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                         torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    # both compute in fp32 from the same bf16 inputs and round once to bf16;
    # they differ only where the fp32 values straddle a rounding boundary:
    # one bf16 ulp, 2^-8 of the largest |y|
    np.testing.assert_allclose(nhwc(got), want, atol=2.0 ** -8 * np.abs(want).max())


def test_ln2d_gradients_match_jax(rng):
    x, scale, bias = _inputs(rng, (1, 4, 4, 32), spread=2.0)
    scale = scale + 0.5

    def loss(a, s, b):
        return jnp.sum(jnp.sin(jln.ln2d_fused(a, s, b)))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    ins = [nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)]
    for t in ins:
        t.requires_grad_(True)
    torch.sin(tln.ln2d_fused(*ins)).sum().backward()
    got = [nhwc(ins[0].grad), ins[1].grad.numpy(), ins[2].grad.numpy()]
    for g, w in zip(got, want):
        # the bound of tests/test_ln2d.py's gradient check
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-5)


@pytest.mark.parametrize("c,dtype,inputs", [
    (32, "float32", "mean 10, spread 0.05"), (32, "bfloat16", "mean 10, spread 0.05"),
    (32, "float32", "normal"), (512, "float32", "normal"),
    (32, "bfloat16", "normal"), (512, "bfloat16", "normal"),
])
def test_layernorm2d_module_matches_jax(rng, c, dtype, inputs):
    """The JAX module's one-pass variance E[x²] − u². At inputs of 10 ± 0.05
    it cancels ~15 of fp32's 24 bits, and a centred variance (the port's
    formula before) differs from it by ~1e-2 of max|y|."""
    shape = (2, 6, 5, c)
    x = rng.standard_normal(shape).astype(np.float32)
    if inputs != "normal":
        x = 10.0 + 0.05 * x
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    variables = perturb(jax_init(jb.LayerNorm2d(), xj), rng)
    want = np.asarray(jax.jit(jb.LayerNorm2d().apply)(variables, xj).astype(jnp.float32))
    module = port(tb.LayerNorm2d(c), variables)
    with torch.no_grad():
        got = module(nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    top = np.abs(want).max()
    if dtype == "bfloat16":
        # one bf16 ulp of the largest output (a rounding-boundary straddle)
        atol = 2.0 ** -8 * top
    elif inputs == "normal":
        atol = 1e-5  # fp32 sums in another order at C 512 (tests/test_ln2d.py's bound)
    else:
        # C 32: the same summation order and rounding as XLA's; a few ulps
        # for the affine's mul-add, which one side may fuse
        atol = 1e-6 * top
    np.testing.assert_allclose(nhwc(got), want, atol=atol)


def test_no_residuals_without_gradients(rng):
    x = nchw(rng.standard_normal((1, 4, 4, 8)).astype(np.float32))
    w, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with torch.inference_mode():
            assert tln.ln2d_fused(x, w, b).grad_fn is None
        with torch.no_grad():
            assert tln.ln2d_fused(x.requires_grad_(True), w, b).grad_fn is None
        assert tln.ln2d_fused(x.detach(), w.detach(), b.detach()).grad_fn is None
        assert saved == []
        out = tln.ln2d_fused(x, w, b)
    assert len(saved) == 3 and "LayerNorm2dFn" in type(out.grad_fn).__name__


def test_wrapper_rejects_unsupported_devices():
    x = torch.zeros((1, 4, 2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tln.ln2d(x, torch.ones(4, device="meta"), torch.zeros(4, device="meta"))


def test_kernel_source_targets_hopper():
    src = tln.SOURCE.read_text()
    for name in tln._SIGNATURES:
        assert f'extern "C" int {name}(' in src or f'extern "C" const char* {name}(' in src
