"""The port's flash attention, forward and backward, against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in interpret mode. N=1024 at block 1024 really reaches the Pallas kernels
(the JAX wrapper's N % block fallback is not taken). Forward tolerance 2e-5,
the JAX package's own kernel tolerance (tests/test_flash_attention.py);
gradients at that package's 5e-4 / 1e-3 or tighter, as stated per test.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from midd_tpu.models.blocks import AttentionBlock as JAttentionBlock
from midd_tpu.ops.flash_attention import _flash_padded_bwd, _fwd_call, _pad_lane
from midd_tpu.ops.flash_attention import mha_flash as jax_mha_flash
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.models import blocks as port_blocks
from midd_tpu_torch.ops import flash_attention as port_flash
from midd_tpu_torch.ops.attention import mha, mha_reference
from tests.torch_port_util import jax_init, nchw, nhwc, port

ATOL = 2e-5


@pytest.mark.parametrize("d", [64, 96])
def test_plain_matches_pallas_kernel_o_and_lse(rng, d):
    bh, n = 2, 1024
    q, k, v = (rng.standard_normal((bh, n, d), dtype=np.float32) for _ in range(3))
    o_j, lse_j = _fwd_call(
        _pad_lane(jnp.asarray(q)), _pad_lane(jnp.asarray(k)), _pad_lane(jnp.asarray(v)),
        1024, 1024, 1.0 / math.sqrt(d), True,
    )
    o_j = np.asarray(o_j)[:, :, :d]
    lse_j = np.asarray(lse_j)[:, 0, :]
    o_t, lse_t = port_flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert o_t.shape == (bh, n, d) and lse_t.shape == (bh, n)
    assert lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=ATOL)


@pytest.mark.parametrize("n,d", [(1024, 96), (64, 8)])
def test_mha_matches_jax_mha_flash(rng, n, d):
    q, k, v = (rng.standard_normal((1, n, 2, d), dtype=np.float32) for _ in range(3))
    ref = np.asarray(jax_mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(mha(tq, tk, tv).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(port_flash.mha_flash(tq, tk, tv).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(mha_reference(tq, tk, tv).numpy(), ref, atol=ATOL)


def test_cpu_wrapper_launches_nothing(rng):
    q = torch.from_numpy(rng.standard_normal((2, 100, 24), dtype=np.float32))
    before = port_flash.flash_attention.launches
    o, lse = port_flash.flash_attention(q, q, q)
    assert port_flash.flash_attention.launches == before
    assert o.shape == q.shape and lse.shape == (2, 100)


def test_plain_keeps_bf16_output_dtype(rng):
    q = torch.from_numpy(rng.standard_normal((2, 50, 16), dtype=np.float32)).bfloat16()
    o, lse = port_flash.flash_attention_plain(q, q, q)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o32, lse32 = port_flash.flash_attention_plain(q.float(), q.float(), q.float())
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), atol=0)


def test_wrapper_rejects_unsupported_devices():
    q = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_flash.flash_attention(q, q, q)


def test_kernel_source_and_build_flags_target_hopper():
    src = port_flash.SOURCE.read_text()
    assert 'extern "C" int midd_flash_fwd' in src
    assert "arch=compute_90a,code=sm_90a" in port_flash.NVCC_FLAGS
    bwd = port_flash.BWD_SOURCE.read_text()
    for name in port_flash._SIGNATURES[port_flash.BWD_SOURCE]:
        assert f'extern "C" int {name}(' in bwd or f'extern "C" const char* {name}(' in bwd


_MMA_HELPERS = ("warp_gemm_nt", "warp_gemm_pv", "load_rows")


@pytest.mark.parametrize("source,kernel", [
    (port_flash.SOURCE, "flash_fwd_kernel"),
    (port_flash.BWD_SOURCE, "flash_bwd_dq_kernel"),
    (port_flash.BWD_SOURCE, "flash_bwd_dkv_kernel"),
])
def test_kernels_issue_tensor_core_products_and_async_copies(source, kernel):
    """The forward, dq and dk/dv kernels take their products and tiles from
    the warp helpers of ``flash_mma.cuh``, which issue tensor-core products,
    asynchronous copies and the fp32 path's TF32 split: a return to a loop
    of CUDA-core FMAs would drop the helpers from the kernel's body."""
    text = source.read_text()
    start = text.index(f"\n{kernel}(")
    body = text[start:text.index("\n}\n", start)]
    header = (source.parent / "flash_mma.cuh").read_text()
    for helper in _MMA_HELPERS:
        assert f"{helper}<" in body, helper
        assert re.search(rf"\b{helper}\(", header), helper
    for instruction in ("mma.sync", "ldmatrix", "cp.async", "cvt.rna.tf32.f32"):
        assert instruction in header, instruction


# -- the backward ----------------------------------------------------------------


def _jax_pallas_bwd(q, k, v, do, dtype=jnp.float32):
    """The JAX package's two Pallas backward kernels (interpret mode) on
    lane-padded (BH, N, D) inputs in ``dtype``, from its own forward's
    (O, lse). Returns (dq, dk, dv) as fp32 numpy, and that O and lse."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = (_pad_lane(jnp.asarray(a, dtype=dtype)) for a in (q, k, v, do))
    o, lse = _fwd_call(qp, kp, vp, 1024, 1024, scale, True)
    dq, dk, dv = _flash_padded_bwd(1024, 1024, scale, True, (qp, kp, vp, o, lse), dop)
    f32 = lambda x: np.array(x.astype(jnp.float32))[:, :, :d]
    return tuple(f32(g) for g in (dq, dk, dv)), f32(o), np.array(lse)[:, 0, :]


@pytest.mark.parametrize("d", [64, 96])
def test_bwd_plain_matches_pallas_kernels(rng, d):
    bh, n = 2, 1024
    q, k, v, do = (rng.standard_normal((bh, n, d), dtype=np.float32) for _ in range(4))
    want, _, _ = _jax_pallas_bwd(q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = port_flash.flash_attention(tq, tk, tv)
    before = (port_flash.flash_bwd_dq.launches, port_flash.flash_bwd_dkv.launches)
    got = port_flash.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    assert (port_flash.flash_bwd_dq.launches, port_flash.flash_bwd_dkv.launches) == before
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == (bh, n, d)
        # fp32 on both sides, another summation order over N = 1024 keys
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("d", [64, 96])
def test_bwd_plain_matches_pallas_kernels_bf16(rng, d):
    """bf16 inputs through the Pallas backward (interpret mode) and the
    port's plain backward, both given the Pallas forward's O and lse, so only
    the backward's arithmetic is compared: ds and p^T rounded to bf16 before
    their products. A plain version that kept them in fp32 agrees with the
    kernels only to ~1e-4 of max|dX| on average; the port agrees to ~1e-8."""
    bh, n = 2, 1024
    q, k, v, do = (rng.standard_normal((bh, n, d), dtype=np.float32) for _ in range(4))
    do *= rng.uniform(0.1, 2.0, (bh, n, 1)).astype(np.float32)  # non-uniform dO
    want, o, lse = _jax_pallas_bwd(q, k, v, do, jnp.bfloat16)
    tq, tk, tv, tdo, to = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do, o))
    got = port_flash.flash_attention_bwd(tq, tk, tv, to, torch.from_numpy(lse), tdo)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (bh, n, d)
        err, top = np.abs(a.float().numpy() - b), np.abs(b).max()
        # The two differ only where an fp32 sum, taken in another order, lands
        # ds, p^T or dX on the other side of a bf16 rounding boundary: two bf16
        # ulps of the largest gradient, the bound the card holds its kernels
        # to. The mean error catches a rounding point moved: measured
        # <= 8e-8 * max|dX|; the bound 2^-16 * max|dX| (1.5e-5) sits 6x below
        # what keeping ds and p^T in fp32 gives (1e-4 to 1.8e-4).
        assert err.max() <= 2.0 ** -7 * top, (name, err.max(), top)
        assert err.mean() <= 2.0 ** -16 * top, (name, err.mean(), top)


@pytest.mark.parametrize("d", [64, 96])
def test_mha_gradients_match_jax_grad_through_pallas(rng, d):
    """jax.grad through ``mha_flash`` reaches the Pallas backward; the port's
    ``mha`` (the exact path on the CPU) and ``mha_flash`` (the autograd
    Function, with the plain backward) are differentiated by torch."""
    shape = (1, 1024, 2, d)
    q, k, v, w = (rng.standard_normal(shape, dtype=np.float32) for _ in range(4))
    jg = jax.grad(lambda q, k, v: jnp.sum(jax_mha_flash(q, k, v) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for fn in (mha, port_flash.mha_flash):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        (fn(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
        for name, a, b in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
            # the JAX package's gradient tolerance (tests/test_flash_attention.py)
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=5e-4, rtol=1e-3,
                                       err_msg=f"{fn.__name__} {name}")


@pytest.mark.parametrize("attention", ["mha", "mha_flash"])
def test_attention_block_value_and_grads_match_jax(rng, attention):
    """Mirrors tests/test_flash_attention.py's AttentionBlock check: the JAX
    block with the Pallas kernel (h*w = 1024 reaches it) against the port's
    block on the same weights, value and every gradient."""
    # use_flash=True routes the CPU block through the autograd Function
    use_flash = attention == "mha_flash"
    x = rng.standard_normal((1, 32, 32, 8), dtype=np.float32)
    jblk = JAttentionBlock(use_flash=True)
    variables = jax_init(jblk, jnp.zeros((1, 32, 32, 8)))
    lj = lambda p, x: jnp.sum(jblk.apply(p, x) ** 2)
    vj, (gj, gxj) = jax.value_and_grad(lj, argnums=(0, 1))(variables, jnp.asarray(x))
    tblk = port(port_blocks.AttentionBlock(8, use_flash=use_flash), variables)
    tx = nchw(x).requires_grad_(True)
    vt = (tblk(tx) ** 2).sum()
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(gxj), atol=5e-4, rtol=1e-3)
    want = port_blocks.AttentionBlock(8)
    want.load_state_dict(state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, gj["params"])}))
    for (name, p), (_, g) in zip(tblk.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(), atol=5e-4, rtol=1e-3, err_msg=name)


def test_no_residuals_without_gradients(rng):
    q = torch.from_numpy(rng.standard_normal((1, 40, 2, 8), dtype=np.float32))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with torch.inference_mode():
            assert port_flash.mha_flash(q, q, q).grad_fn is None
        assert port_flash.mha_flash(q, q, q).grad_fn is None  # no input requires grad
        with torch.no_grad():
            assert port_flash.mha_flash(q.requires_grad_(True), q, q).grad_fn is None
        assert saved == []
        out = port_flash.mha_flash(q, q, q)
    assert len(saved) >= 5  # q, k, v, O, lse, beside what the layout ops save
    fn = out.grad_fn
    while fn is not None and "FlashAttention" not in type(fn).__name__:
        fn = fn.next_functions[0][0]
    assert fn is not None


def test_bwd_wrapper_rejects_unsupported_devices():
    q = torch.zeros((1, 4, 8), device="meta")
    lse = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_flash.flash_attention_bwd(q, q, q, q, lse, q)


def test_bwd_plain_rounds_bf16_like_the_kernels(rng):
    """bf16: ds and p^T are rounded to bf16 before their products, so the
    plain version differs from its fp32 run by about a bf16 ulp of max|dX|,
    not by nothing."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 64, 16), dtype=np.float32)).bfloat16()
                   for _ in range(4))
    o, lse = port_flash.flash_attention_plain(q, k, v)
    g16 = port_flash.flash_attention_bwd_plain(q, k, v, o, lse, do)
    g32 = port_flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float())
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b).abs().max().item()
        assert 0 < err <= 2.0 ** -6 * b.abs().max().item()
