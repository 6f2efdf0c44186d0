"""The fused NAFBlock FFN half (``midd_tpu_torch/ops/naf_ffn.py``) and the
functional fused forward (``ops/naf_fast.py``) against the JAX package's
Pallas ``naf_ffn_fused`` and ``nafnet_apply_fused``, run in interpret mode on
the CPU as tests/test_naf_ffn.py runs them. On the CPU the port runs the
kernel's plain version; the kernel is held against that on the card
(tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.ops.naf_fast import nafnet_apply_fused as jax_nafnet_apply_fused
from midd_tpu.ops.naf_ffn import naf_ffn_fused as jax_naf_ffn_fused
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.models.nafnet import EnhancedNAFNet
from midd_tpu_torch.ops import naf_ffn as tffn
from midd_tpu_torch.ops.naf_fast import nafnet_apply_fused
from tests.torch_port_util import image, jax_init, nchw, nhwc, perturb, port


def _ffn_inputs(rng, c):
    """tests/test_naf_ffn.py's inputs: NHWC y and the (C, 2C) / (C, C)
    matmul kernels of the JAX layout."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(2, 8, 9, c), f(c), f(c), 0.1 * f(c, 2 * c), 0.1 * f(2 * c), 0.1 * f(c, c),
            0.1 * f(c), 0.1 * f(c))


def _port_args(y, scale, bias, w4, b4, w5, b5, gamma):
    """The same values as the port's modules hold them: NCHW y, conv weights
    (out, in, 1, 1), gamma (1, C, 1, 1)."""
    c = y.shape[-1]
    t = torch.from_numpy
    return (nchw(y), t(scale), t(bias), t(np.ascontiguousarray(w4.T)).view(2 * c, c, 1, 1), t(b4),
            t(np.ascontiguousarray(w5.T)).view(c, c, 1, 1), t(b5), t(gamma).view(1, c, 1, 1))


@pytest.mark.parametrize("c", [32, 128, 192])
def test_naf_ffn_matches_jax_kernel(rng, c):
    args = _ffn_inputs(rng, c)
    want = np.asarray(jax_naf_ffn_fused(*map(jnp.asarray, args), block_rows=64))
    ported = _port_args(*args)
    plain = tffn.naf_ffn_plain(*ported)
    with torch.no_grad():
        fused = tffn.naf_ffn_fused(*ported)  # the CPU takes the plain version
    assert torch.equal(fused, plain)
    # fp32 products of C terms in another order: the bound of tests/test_naf_ffn.py
    np.testing.assert_allclose(nhwc(plain), want, atol=2e-4)


def test_naf_ffn_bf16_rounds_once(rng):
    args = _port_args(*_ffn_inputs(rng, 32))
    yb = args[0].bfloat16()
    got = tffn.naf_ffn_plain(yb, *args[1:])
    assert got.dtype == torch.bfloat16
    want = tffn.naf_ffn_plain(yb.float(), *args[1:])
    assert torch.equal(got, want.bfloat16())


def test_naf_ffn_is_forward_only(rng):
    args = list(_port_args(*_ffn_inputs(rng, 32)))
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tffn.naf_ffn_fused(*args)
    with torch.no_grad():
        assert tffn.naf_ffn_fused(*args).grad_fn is None


def test_wrapper_rejects_unsupported_devices():
    y = torch.zeros((1, 4, 2, 2), device="meta")
    p = torch.zeros(4, device="meta")
    w = torch.zeros(8, 4, 1, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tffn.naf_ffn_fused(y, p, p, w, torch.zeros(8, device="meta"), w[:4], p, p)


def test_kernel_source_exports_the_wrapper_entry_points():
    src = tffn.SOURCE.read_text()
    for name in tffn._SIGNATURES:
        assert f'extern "C" int {name}(' in src or f'extern "C" const char* {name}(' in src, name


def test_kernel_issues_tensor_core_products_and_async_copies():
    """Both of ``naf_ffn_kernel``'s products go through the warp products of
    ``flash_mma.cuh`` (tensor-core ``mma.sync`` on ``ldmatrix`` fragments:
    ``warp_gemm_nt`` for bf16, ``warp_gemm_nt_tf32x3``'s three TF32 passes for
    fp32) and its weight tiles arrive by ``cp.async``: a return to a loop of
    CUDA-core FMAs would drop the helpers from the kernel's body. Its numerics
    are checked on the card."""
    text = tffn.SOURCE.read_text()
    start = text.index("\nnaf_ffn_kernel(")
    body = text[start:text.index("\n}\n", start)]
    header = (tffn.SOURCE.parent / "flash_mma.cuh").read_text()
    for helper in ("warp_gemm_nt", "warp_gemm_nt_tf32x3", "cp_async16"):
        assert re.search(rf"\b{helper}[<(]", body), helper
        assert re.search(rf"\b{helper}\(", header), helper
    start = header.index("warp_gemm_nt_tf32x3(")
    tf32x3 = header[start:header.index("\n}\n", start)]
    for piece in ("ldsm_x4(", "mma_tf32_1688(", "split_tf32_fast("):
        assert piece in tf32x3, piece
    for instruction in ("mma.sync", "ldmatrix", "cp.async", "cvt.rna.tf32.f32"):
        assert instruction in header, instruction


def test_nafnet_apply_fused_matches_jax_and_the_module(rng):
    """A width whose stages reach C 128 and 256, so that JAX's forward runs
    its kernel branch (C >= MIN_FUSED_CHANNELS) as well as its XLA one; the
    port fuses at every C."""
    kw = dict(width=32, middle_blk_num=1, enc_blk_nums=(1, 1, 1), dec_blk_nums=(1, 1, 1))
    jcf, tcf = jcfg.NAFNetConfig(**kw), tcfg.NAFNetConfig(**kw)
    x = image(rng, 1, 16, 16, 1)
    jmodel = jm.EnhancedNAFNet(jcf)
    variables = perturb(jax_init(jmodel, jnp.asarray(x)), rng)
    want = np.asarray(jax.jit(lambda p, a: jax_nafnet_apply_fused(p, jcf, a))(
        variables["params"], jnp.asarray(x)))
    model = port(EnhancedNAFNet(tcf), variables)
    with torch.no_grad():
        got = nafnet_apply_fused(model, nchw(x))
        module = model(nchw(x))
    # the tolerance of tests/test_naf_ffn.py's functional-forward check
    np.testing.assert_allclose(nhwc(got), want, atol=5e-4)
    np.testing.assert_allclose(nhwc(got), nhwc(module), atol=5e-4)
