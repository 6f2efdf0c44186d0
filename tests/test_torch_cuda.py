"""The hand-written kernels on the card (flash-attention forward; backward dq
and dk/dv; LayerNorm2d; the fused NAFBlock FFN half): agreement with their
plain versions (the tensor-core flash kernels also at their tile and ring
edges, by plain loads and off 16-byte alignment; LayerNorm2d in both
layouts, at every served stage and at its edges; both NAFNet kernels at
every MODEL2_NAFNET stage), the launch counts, gradients through ``mha``
and through ``LayerNorm2d``, and the wrappers' refusals; and the int8
convolutions' integer product (``torch._int_mm``) against its plain
version; and the quality benchmark's ``score_fn`` card against CPU. Marked ``cuda``;
skipped where there is no GPU. This file imports no JAX, so on a machine
without JAX run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from midd_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(bh, n, d, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(3)]


@pytest.mark.parametrize("bh,n,d,dtype", [
    (2, 4096, 96, torch.bfloat16),
    (2, 4096, 96, torch.float32),
    (16, 1024, 96, torch.bfloat16),  # a bucket-8 batch at 256²: 8 images x 2 heads
    (16, 1024, 96, torch.float32),
    (3, 777, 128, torch.float32),
    (1, 1, 1, torch.float32),
    (4, 130, 40, torch.bfloat16),
    # the wide UNet's heads of 192: a scored batch of 4 (bf16) and a training step of 2 (fp32)
    (8, 1024, 192, torch.bfloat16),
    (4, 1024, 192, torch.float32),
    (3, 333, 136, torch.float32),  # Dp 192 from D 129 up
    (2, 100, 130, torch.bfloat16),  # a row of 260 bytes: plain loads
])
def test_kernel_matches_plain(cuda, bh, n, d, dtype):
    _check_fwd(*_qkv(bh, n, d, dtype))


def _check_fwd(q, k, v):
    bh, n, _ = q.shape
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float())
    assert o.dtype == q.dtype and lse.dtype == torch.float32 and lse.shape == (bh, n)
    # bf16: two bf16 ulps of the largest output (reasons in chip_smoke.py)
    tol = 2.0 ** -7 * o_ref.abs().max().item() if q.dtype == torch.bfloat16 else 1e-5
    assert (o.float() - o_ref).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-5


def test_mha_flash_matches_reference(cuda):
    from midd_tpu_torch.ops.attention import mha, mha_reference

    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 300, 2, 48, generator=gen).cuda() for _ in range(3))
    assert (mha(q, k, v) - mha_reference(q, k, v)).abs().max().item() <= 1e-5


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(2, 64, 32, torch.float32)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="unsupported shape"):
        big = torch.zeros(1, 8, fa.MAX_D + 1, device="cuda")
        fa.flash_attention(big, big, big)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("bh,n,d,dtype", [
    (2, 4096, 96, torch.float32),
    (2, 4096, 96, torch.bfloat16),
    (2, 1000, 64, torch.bfloat16),
    (3, 77, 128, torch.float32),
    (1, 1, 1, torch.float32),
    (4, 1024, 192, torch.float32),  # the wide UNet's training step (fp32, 32-query tiles in dk/dv)
    (8, 1024, 192, torch.bfloat16),
    (3, 333, 136, torch.float32),
    (2, 100, 130, torch.bfloat16),
])
def test_bwd_kernels_match_plain(cuda, bh, n, d, dtype):
    q, k, v = _qkv(bh, n, d, dtype)
    do = _qkv(bh, n, d, dtype, seed=1)[0]
    o, lse = fa.flash_attention(q, k, v)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    # relative to max|dX| of the plain version (reasons in chip_smoke.py)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        assert (a.float() - b.float()).abs().max().item() <= rel * b.float().abs().max().item()


# -- the tensor-core flash kernels at the tile and ring edges ----------------------
# N around the 16-row warp tiles and the 64-row block and ring tiles, D around
# the 16-column k steps, BH 1 and 3, both dtypes; each against its plain
# version at the bounds above.
EDGE = [(bh, n, d, dtype) for n in (1, 15, 17, 63, 65, 1000) for d in (8, 40, 72, 96, 128)
        for bh in (1, 3) for dtype in (torch.float32, torch.bfloat16)]
# D * itemsize not a multiple of 16: the same kernels take their tiles by
# plain loads instead of 16-byte cp.async copies
PLAIN_LOADS = [(2, 130, 7, torch.float32), (2, 130, 7, torch.bfloat16),
               (1, 200, 36, torch.bfloat16), (3, 65, 100, torch.bfloat16)]


def _check_dkv(q, k, v, do):
    bh, n, d = q.shape
    o, lse = fa.flash_attention(q, k, v)
    delta = fa._delta(o, do)
    before = fa.flash_bwd_dkv.launches
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dkv.launches == before + 1
    want_k, want_v = fa.bwd_dkv_plain(q, k, v, do, lse, delta)
    rel = 2.0 ** -7 if q.dtype == torch.bfloat16 else 1e-5
    top_k = want_k.float().abs().max().item()
    if n == 1:
        # One key: the softmax over it has no gradient, ds = p (dO.v - delta)
        # is 0 in exact arithmetic, and dk of either version is the rounding
        # noise of two sums in their own orders. Hold the kernel's to rel of
        # the size of those sums' terms, scale * p (|dO| |v| + |delta|) |q|.
        p, scale = fa._recompute_p(q, k, lse)
        terms = p * (do.float().abs() @ v.float().abs().transpose(-1, -2) + delta.abs()[..., None])
        top_k = (scale * terms.transpose(-1, -2) @ q.float().abs()).max().item()
    for got, want, top in ((dk, want_k, top_k), (dv, want_v, want_v.float().abs().max().item())):
        assert got.dtype == q.dtype and got.shape == q.shape
        assert (got.float() - want.float()).abs().max().item() <= rel * top


def _check_dq(q, k, v, do):
    bh, n, d = q.shape
    o, lse = fa.flash_attention(q, k, v)
    delta = fa._delta(o, do)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == before + 1
    want = fa.bwd_dq_plain(q, k, v, do, lse, delta)
    rel = 2.0 ** -7 if q.dtype == torch.bfloat16 else 1e-5
    top = want.float().abs().max().item()
    if n == 1:
        # One key: ds = p (dO.v - delta) is 0 in exact arithmetic (as for dk
        # in _check_dkv), so dq of either version is rounding noise. Hold the
        # kernel's to rel of the size of those sums' terms, scale * p (|dO|
        # |v| + |delta|) |k|.
        p, scale = fa._recompute_p(q, k, lse)
        terms = p * (do.float().abs() @ v.float().abs().transpose(-1, -2) + delta.abs()[..., None])
        top = (scale * terms @ k.float().abs()).max().item()
    assert dq.dtype == q.dtype and dq.shape == q.shape
    assert (dq.float() - want.float()).abs().max().item() <= rel * top


@pytest.mark.parametrize("bh,n,d,dtype", EDGE)
def test_fwd_kernel_edges_match_plain(cuda, bh, n, d, dtype):
    _check_fwd(*_qkv(bh, n, d, dtype))


@pytest.mark.parametrize("bh,n,d,dtype", EDGE)
def test_dkv_kernel_edges_match_plain(cuda, bh, n, d, dtype):
    _check_dkv(*_qkv(bh, n, d, dtype), _qkv(bh, n, d, dtype, seed=1)[0])


@pytest.mark.parametrize("bh,n,d,dtype", EDGE)
def test_dq_kernel_edges_match_plain(cuda, bh, n, d, dtype):
    _check_dq(*_qkv(bh, n, d, dtype), _qkv(bh, n, d, dtype, seed=1)[0])


@pytest.mark.parametrize("bh,n,d,dtype", PLAIN_LOADS)
def test_kernels_load_rows_without_async_copies(cuda, bh, n, d, dtype):
    q, k, v = _qkv(bh, n, d, dtype)
    do = _qkv(bh, n, d, dtype, seed=1)[0]
    _check_fwd(q, k, v)
    _check_dkv(q, k, v, do)
    _check_dq(q, k, v, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_operands_off_16_byte_alignment(cuda, dtype):
    """A contiguous view one element into its storage is not 16-byte aligned:
    the kernels load it with plain loads."""
    bh, n, d = 2, 130, 96
    q, k, v = _qkv(bh, n, d, dtype)
    flat = torch.empty(bh * n * d + 1, device="cuda", dtype=dtype)
    q_off = flat[1:].view(bh, n, d)
    q_off.copy_(q)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 != 0
    do = _qkv(bh, n, d, dtype, seed=1)[0]
    _check_fwd(q_off, k, v)
    _check_dkv(q_off, k, v, do)
    _check_dq(q_off, k, v, do)


def test_mha_gradients_on_the_card_come_from_the_kernels(cuda):
    from midd_tpu_torch.ops.attention import mha, mha_reference

    gen = torch.Generator().manual_seed(2)
    q, k, v, w = (torch.randn(2, 300, 2, 48, generator=gen).cuda() for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = torch.autograd.grad((mha(q, k, v) * w).sum(), (q, k, v))
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad((mha_reference(q, k, v) * w).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-7


def test_bwd_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(2, 64, 32, torch.float32)
    o, lse = fa.flash_attention(q, k, v)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd(q, k, v, o, lse, o.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention_bwd(q, k, v, o, lse, o.bfloat16())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, None], o)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


# -- LayerNorm2d and the fused FFN half --------------------------------------------


def _ln_inputs(b, c, h, w, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (2.5 + torch.randn(b, c, h, w, generator=gen)).to("cuda", dtype)  # mean 2.5x the spread
    return (x, (1 + 0.2 * torch.randn(c, generator=gen)).cuda(),
            (0.2 * torch.randn(c, generator=gen)).cuda())


LAYOUT_CASES = [
    (1, 32, 128, 128, torch.float32, "nchw"), (2, 64, 64, 64, torch.bfloat16, "nchw"),
    (1, 512, 32, 32, torch.float32, "nchw"), (2, 256, 16, 16, torch.bfloat16, "nchw"),
    (2, 48, 37, 29, torch.float32, "nchw"), (1, 1, 1, 1, torch.float32, "nchw"),
    (1, 32, 128, 128, torch.float32, "channels_last"), (2, 48, 37, 29, torch.bfloat16, "channels_last"),
    (2, 64, 9, 1, torch.float32, "channels_last"),
]


# LayerNorm2d also in channels-last at every SERVE_NAFNET stage of a 512²
# input past C 32 (the staged kernel's pixels per block fall from 64 to 8),
# at small P (C 512 at 4x4: one and two blocks), at C 1 and C 7 (scalar
# loads in bf16), and on a view one element into its storage (scalar loads)
_FP, _BF = torch.float32, torch.bfloat16
LN_CASES = LAYOUT_CASES + [
    (1, 64, 256, 256, _FP, "channels_last"), (1, 128, 128, 128, _FP, "channels_last"),
    (1, 256, 64, 64, _FP, "channels_last"), (1, 512, 32, 32, _FP, "channels_last"),
    (2, 128, 128, 128, _BF, "channels_last"), (2, 512, 32, 32, _BF, "channels_last"),
    (1, 512, 4, 4, _FP, "channels_last"), (2, 512, 4, 4, _FP, "channels_last"),
    (2, 512, 4, 4, _BF, "channels_last"),
    (2, 1, 9, 7, _FP, "channels_last"), (2, 7, 9, 7, _FP, "channels_last"),
    (2, 7, 9, 7, _BF, "channels_last"),
    (2, 64, 9, 7, _FP, "channels_last_offset"), (2, 64, 9, 7, _BF, "channels_last_offset"),
    # a bucket-8 batch at 256², the served layout
    (8, 32, 256, 256, _FP, "channels_last"), (8, 512, 16, 16, _BF, "channels_last"),
]
# MODEL2_NAFNET's stages of a 512² input (C 24 to 384), both dtypes and layouts
MODEL2_STAGES = [(1, c, h, h, dtype, layout) for c, h in ((24, 512), (48, 256), (96, 128), (192, 64), (384, 32))
                 for dtype in (_FP, _BF) for layout in ("nchw", "channels_last")]
LN_CASES += MODEL2_STAGES


def _layout(x, layout):
    if layout == "channels_last_offset":
        # channels-last strides, one element into its storage: not 16-byte aligned
        b, c, h, w = x.shape
        flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
        view = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
        view.copy_(x)
        assert view.is_contiguous(memory_format=torch.channels_last) and view.data_ptr() % 16 != 0
        return view
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


@pytest.mark.parametrize("b,c,h,w,dtype,layout", LN_CASES)
def test_ln2d_kernel_matches_plain(cuda, b, c, h, w, dtype, layout):
    from midd_tpu_torch.ops import ln2d as ln

    x, scale, bias = _ln_inputs(b, c, h, w, dtype)
    x = _layout(x, layout)
    before = ln.ln2d.launches
    y = ln.ln2d(x, scale, bias)
    torch.cuda.synchronize()
    assert ln.ln2d.launches == before + 1 and y.dtype == dtype and y.stride() == x.stride()
    ref = ln.ln2d_plain(x, scale, bias).float()
    # fp32: the same summation order and division with every step rounded as
    # written, so the same bits at every C (reasons in chip_smoke.py); bf16:
    # two bf16 ulps of the largest output
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (y.float() - ref).abs().max().item() <= rel * ref.abs().max().item()
    if dtype == torch.float32:
        assert torch.equal(y, ref)


def test_layernorm2d_gradients_on_the_card(cuda):
    """The norms' weight and bias and the conv in front of them get the
    gradients the CPU computes (the kernel writes a tensor with no history;
    ``LayerNorm2dFn`` must carry it)."""
    from midd_tpu_torch.models.blocks import Conv2d, LayerNorm2d
    from midd_tpu_torch.ops import ln2d as ln

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 20, 24, generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)  # the same weights, drawn on the CPU, on both devices
        net = torch.nn.Sequential(Conv2d(4, 64, 3), LayerNorm2d(64))
        with torch.no_grad():
            net[1].weight.uniform_(0.5, 1.5)
            net[1].bias.uniform_(-0.5, 0.5)
        net = net.to(dev)
        before = ln.ln2d.launches
        (net(x.to(dev)).sin() * 1.5).sum().backward()
        if dev == "cuda":
            assert ln.ln2d.launches == before + 1
        grads[dev] = {n: p.grad.cpu() for n, p in net.named_parameters()}
    for n, g in grads["cpu"].items():
        assert g.abs().max() > 0 and torch.isfinite(grads["cuda"][n]).all(), n
        assert (grads["cuda"][n] - g).abs().max() <= 1e-4 * g.abs().max(), n


def test_ln2d_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from midd_tpu_torch.ops import ln2d as ln

    x, scale, bias = _ln_inputs(1, 8, 4, 4, torch.float32)
    before = ln.ln2d.launches
    with pytest.raises(ValueError, match="contiguous"):
        ln.ln2d(x.transpose(2, 3), scale, bias)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ln.ln2d(x.half(), scale, bias)
    with pytest.raises(ValueError, match="scale"):
        ln.ln2d(x, scale.double(), bias)
    assert ln.ln2d.launches == before


def _ffn_inputs(b, c, h, w, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    y = r(b, c, h, w).to("cuda", dtype)
    params = (1 + 0.2 * r(c), 0.2 * r(c), r(2 * c, c, 1, 1) * c ** -0.5, 0.1 * r(2 * c),
              r(c, c, 1, 1) * c ** -0.5, 0.1 * r(c), 0.2 * r(1, c, 1, 1))
    return (y, *(p.cuda() for p in params))


# The tensor-core FFN kernel also at C not a multiple of the mma depth or of
# 16 bytes (C 1 and 7: weights by plain loads), at P not a multiple of a
# block's rows (128 at C 32, 32 at C 256 at 64², 16 where few blocks), at C 512
# at batch 2 in bf16, and on a view one element into its storage
FFN_CASES = LAYOUT_CASES + [
    (2, 7, 9, 7, _FP, "nchw"), (2, 7, 9, 7, _BF, "channels_last"), (2, 1, 9, 7, _BF, "nchw"),
    (1, 48, 16, 16, _BF, "nchw"), (1, 32, 130, 131, _FP, "nchw"), (1, 32, 130, 131, _BF, "channels_last"),
    (1, 256, 64, 64, _FP, "channels_last"), (1, 256, 63, 65, _BF, "nchw"),
    (2, 512, 32, 32, _BF, "nchw"), (2, 512, 32, 32, _BF, "channels_last"),
    (2, 64, 9, 7, _FP, "channels_last_offset"), (2, 64, 9, 7, _BF, "channels_last_offset"),
] + MODEL2_STAGES


@pytest.mark.parametrize("b,c,h,w,dtype,layout", FFN_CASES)
def test_naf_ffn_kernel_matches_plain(cuda, b, c, h, w, dtype, layout):
    from midd_tpu_torch.ops import naf_ffn as ffn

    args = list(_ffn_inputs(b, c, h, w, dtype))
    args[0] = _layout(args[0], layout)
    before = ffn.naf_ffn_fused.launches
    out = ffn.naf_ffn_fused(*args)
    torch.cuda.synchronize()
    assert ffn.naf_ffn_fused.launches == before + 1 and out.dtype == dtype and out.stride() == args[0].stride()
    ref = ffn.naf_ffn_plain(*args).float()
    # fp32: products of C terms in another order; bf16: two bf16 ulps
    # (reasons in chip_smoke.py)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [_FP, _BF])
def test_naf_ffn_kernel_at_its_largest_c(cuda, dtype):
    """The largest C the kernel takes: a 16-row block's shared memory at its
    limit, P (9) under one block."""
    from midd_tpu_torch.ops import _build
    from midd_tpu_torch.ops import naf_ffn as ffn

    c = _build.library(ffn.SOURCE, ffn._SIGNATURES).midd_naf_ffn_max_channels()
    assert c >= 512
    y, *params = _ffn_inputs(1, c, 3, 3, dtype)
    out = ffn.naf_ffn_fused(y, *params)
    ref = ffn.naf_ffn_plain(y, *params).float()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref).abs().max().item() <= rel * ref.abs().max().item()


def test_naf_ffn_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from midd_tpu_torch.ops import naf_ffn as ffn

    y, *params = _ffn_inputs(1, 16, 4, 4, torch.float32)
    before = ffn.naf_ffn_fused.launches
    with pytest.raises(ValueError, match="contiguous"):
        ffn.naf_ffn_fused(y.transpose(2, 3), *params)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ffn.naf_ffn_fused(y.half(), *params)
    with pytest.raises(ValueError, match="parameters"):
        ffn.naf_ffn_fused(y, params[0].bfloat16(), *params[1:])
    with pytest.raises(ValueError, match="do not fit"):
        ffn.naf_ffn_fused(y, params[0][:8], *params[1:])
    big = _ffn_inputs(1, 1024, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        ffn.naf_ffn_fused(*big)
    assert ffn.naf_ffn_fused.launches == before


def test_nafnet_apply_fused_on_the_card(cuda):
    from midd_tpu_torch import config
    from midd_tpu_torch.models.blocks import NAFBlock, init_weights
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.ops import naf_ffn as ffn
    from midd_tpu_torch.ops.naf_fast import nafnet_apply_fused

    cfg = config.NAFNetConfig(width=16, middle_blk_num=1, enc_blk_nums=(1, 2), dec_blk_nums=(1, 1))
    model = init_weights(EnhancedNAFNet(cfg), torch.Generator().manual_seed(0)).cuda().eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, NAFBlock):
                mod.beta.copy_(0.3 * torch.randn(mod.beta.shape, generator=gen))
                mod.gamma.copy_(0.3 * torch.randn(mod.gamma.shape, generator=gen))
        x = torch.rand(1, 1, 40, 36, generator=gen).cuda()
        before = ffn.naf_ffn_fused.launches
        got = nafnet_apply_fused(model, x)
        assert ffn.naf_ffn_fused.launches == before + 6  # one per NAFBlock
        want = model(x)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_model2_nafnet_apply_fused_on_the_card(cuda):
    """MODEL2_NAFNET (multiscale intro, additive skips) at 64²: the fused
    forward against the module, 1e-4 of max|out| as above; one naf_ffn
    launch per NAFBlock."""
    from midd_tpu_torch import config
    from midd_tpu_torch.models.blocks import NAFBlock, init_weights
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.ops import naf_ffn as ffn
    from midd_tpu_torch.ops.naf_fast import nafnet_apply_fused

    cfg = config.MODEL2_NAFNET
    model = init_weights(EnhancedNAFNet(cfg), torch.Generator().manual_seed(0)).cuda().eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, NAFBlock):
                mod.beta.copy_(0.3 * torch.randn(mod.beta.shape, generator=gen))
                mod.gamma.copy_(0.3 * torch.randn(mod.gamma.shape, generator=gen))
        x = torch.rand(1, 1, 64, 64, generator=gen).cuda()
        before = ffn.naf_ffn_fused.launches
        got = nafnet_apply_fused(model, x)
        blocks = sum(cfg.enc_blk_nums) + cfg.middle_blk_num + sum(cfg.dec_blk_nums)
        assert ffn.naf_ffn_fused.launches == before + blocks
        want = model(x)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# -- int8 convolutions (ops/qconv.py): the integer product on the card --------------


def _int8_operands(b, c, h, o, k, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (b, c, h, h), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=gen, dtype=torch.int8)
    return xq.cuda(), wq.cuda()


@pytest.mark.parametrize("b,c,h,o,k,stride", [
    (1, 5, 7, 3, 3, 2), (2, 12, 4, 10, 1, 1), (1, 48, 9, 48, 3, 2), (1, 1, 5, 1, 3, 1),
])
def test_int8_product_on_the_card_at_ragged_shapes(cuda, b, c, h, o, k, stride):
    """K and N off multiples of 8, M under 16: ``torch._int_mm``'s padding
    leaves the int32 sums exact."""
    from midd_tpu_torch.ops import qconv

    xq, wq = _int8_operands(b, c, h, o, k)
    got = qconv.int8_conv2d(xq, wq, stride, k // 2)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, qconv.int8_conv2d_plain(xq, wq, stride, k // 2))


def test_int8_product_on_the_card_at_the_served_shapes(cuda):
    """Every int8 conv of SERVE_DIFFUSION at 512², batch 1 (found by running
    the quantised UNet): the card's int32 product equals the plain one bit
    for bit."""
    from midd_tpu_torch import config
    from midd_tpu_torch.models.blocks import init_weights
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
    from midd_tpu_torch.ops import qconv

    unet = init_weights(UNetDiffusion(config.SERVE_DIFFUSION, quant="dynamic"),
                        torch.Generator().manual_seed(0)).cuda().eval()
    shapes = set()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: shapes.add((tuple(a[0].shape), m.out_channels, m.kernel_size[0], m.stride[0])))
        for m in unet.modules() if isinstance(m, qconv.QuantConv2d)]
    x = torch.rand(1, 1, 512, 512, device="cuda")
    before = qconv.int8_conv2d.calls
    with torch.no_grad():
        unet(x, x, torch.zeros(1, dtype=torch.long, device="cuda"))
    assert qconv.int8_conv2d.calls - before == len(hooks)
    for hook in hooks:
        hook.remove()
    for i, ((b, c, h, _), o, k, stride) in enumerate(sorted(shapes)):
        xq, wq = _int8_operands(b, c, h, o, k, seed=i)
        assert torch.equal(qconv.int8_conv2d(xq, wq, stride, k // 2),
                           qconv.int8_conv2d_plain(xq, wq, stride, k // 2)), (b, c, h, o, k, stride)


# -- the cddpm slice, card vs CPU (chip_smoke.py phases 9c and 10e) -----------------


def _cddpm_unet(seed):
    from midd_tpu_torch import config
    from midd_tpu_torch.models.blocks import init_weights
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion

    return init_weights(UNetDiffusion(config.CDDPM_UNET), torch.Generator().manual_seed(seed))


def test_cddpm_train_step_card_vs_cpu(cuda):
    """One cddpm step (CDDPM_UNET, eps-MSE) at 128², batch 1, fp32: 4 flash
    forward, 4 dq and 4 dk/dv launches; the loss to 1e-5 relative and each
    gradient to 1e-4 of its largest entry (floored at 1e-3 of the model's
    largest: the key biases' gradients are zero in exact arithmetic)."""
    from midd_tpu_torch import config
    from midd_tpu_torch.diffusion.schedule import make_schedule
    from midd_tpu_torch.train.trainer import cddpm_loss_fn

    gen = torch.Generator().manual_seed(5)
    clean = torch.rand(1, 1, 128, 128, generator=gen)
    noisy = (clean + 0.1 * torch.randn(clean.shape, generator=gen)).clamp(0, 1)
    eps = torch.randn(clean.shape, generator=gen)
    t = torch.tensor([29])
    sched = make_schedule(config.SERVE_SCHEDULE)
    ah = sched.alpha_hat[t]
    x_t = ah.sqrt() * clean + (1 - ah).sqrt() * eps
    out = {}
    for dev in ("cuda", "cpu"):
        model = _cddpm_unet(41).to(dev)
        before = (fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
        loss, _ = cddpm_loss_fn()(model, (clean.to(dev), noisy.to(dev)),
                                               (t.to(dev), x_t.to(dev), eps.to(dev)))
        loss.backward()
        after = (fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
        out[dev] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                    tuple(a - b for a, b in zip(after, before)))
    (l_gpu, g_gpu, launched), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    assert launched == (4, 4, 4)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    top = max(g.abs().max().item() for g in g_cpu.values())
    for name, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-3 * top)
        assert (g_gpu[name] - g).abs().max().item() <= 1e-4 * scale, name


def test_cddpm_stochastic_rollout_card_vs_cpu(cuda):
    """An ancestral CDDPM_UNET rollout at 256², 8 inference steps (9 scan
    steps of 4 flash forwards), no eps clamp, fp32, both devices fed one
    ``noise_seq``: to 1e-3, the exact rollout's bound."""
    from midd_tpu_torch import config
    from midd_tpu_torch.diffusion.sampler import denoise
    from midd_tpu_torch.diffusion.schedule import make_schedule

    gen = torch.Generator().manual_seed(6)
    x = torch.rand(1, 1, 256, 256, generator=gen)
    seq = torch.randn((9, *x.shape), generator=gen)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = _cddpm_unet(3).to(dev).eval()
        before = fa.flash_attention.launches
        with torch.inference_mode():
            outs[dev] = denoise(model, x.to(dev), make_schedule(config.SERVE_SCHEDULE, dev), 8,
                                stochastic=True, clamp_eps=False, noise_seq=seq.to(dev)).cpu()
        if dev == "cuda":
            assert fa.flash_attention.launches - before == 9 * 4
    assert torch.isfinite(outs["cuda"]).all()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-3


def test_xray_bench_score_fn_card_vs_cpu(cuda):
    """The benchmark's ``score_fn`` on a seeded full-width NAFNet at the
    protocol's 256², run on the card and on the CPU (fp32, TF32 off), over
    one eval image of each noise family. The forwards agree to ~1e-6 of
    max|out| (the 1e-4 bound of ``chip_smoke.py``'s NAFNet card-vs-CPU
    check); with these untrained outputs far from clean, that moves a mean
    PSNR by ~1e-5 dB and an SSIM by ~1e-7: 1e-3 dB and 1e-5 hold them, while
    one layer at TF32 would not fit. 60 ln2d launches a forward."""
    import numpy as np

    from midd_tpu_torch import config
    from midd_tpu_torch.benchmarks import xray_bench
    from midd_tpu_torch.models.blocks import init_weights
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.ops import ln2d as ln

    eval_set = xray_bench.make_eval_set(1, 256)
    scores = {}
    for dev in ("cuda", "cpu"):
        model = init_weights(EnhancedNAFNet(config.SERVE_NAFNET), torch.Generator().manual_seed(9))
        model = model.to(dev).eval()

        def fn(noisy):
            with torch.inference_mode():
                x = torch.from_numpy(noisy).permute(0, 3, 1, 2).to(dev)
                return model(x).clamp(0, 1).permute(0, 2, 3, 1)

        before = ln.ln2d.launches
        scores[dev] = xray_bench.score_fn(fn, eval_set)
        if dev == "cuda":
            assert ln.ln2d.launches - before == 60
    for key, want in scores["cpu"].items():
        got = scores["cuda"][key]
        assert got["n"] == want["n"] and np.isfinite(got["psnr"]), key
        assert abs(got["psnr"] - want["psnr"]) <= 1e-3, (key, got, want)
        assert abs(got["ssim"] - want["ssim"]) <= 1e-5, (key, got, want)


@pytest.mark.parametrize("quant", ["dynamic", "static"])
def test_int8_unet_split_over_tp2_equals_the_whole_on_the_card(cuda, quant):
    """SERVE_DIFFUSION in int8 split over two tp slices of the card
    (``shard_params``) computes one eval bit for bit as the whole model: each
    slice's int32 product is exact, and the fused up/down convolution reads
    NCHW (cuDNN's channels-last kernels sum a half-width convolution in
    another order, which int8 would carry)."""
    import copy

    from midd_tpu_torch import config
    from midd_tpu_torch.models.blocks import init_weights
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
    from midd_tpu_torch.ops.qconv import QuantConv2d
    from midd_tpu_torch.parallel import shard_params

    model = init_weights(UNetDiffusion(config.SERVE_DIFFUSION, use_flash=True, quant=quant),
                         torch.Generator().manual_seed(1)).to(cuda).eval()
    for m in model.modules():
        if isinstance(m, QuantConv2d):
            m.act_absmax = torch.tensor(3.0, device=cuda)
    split = copy.deepcopy(model)
    assert shard_params(split, [cuda] * 2) > 0
    gen = torch.Generator().manual_seed(5)
    x, cond = (torch.rand(1, 1, 256, 256, generator=gen).to(cuda) for _ in range(2))
    t = torch.tensor([30], device=cuda)
    with torch.no_grad():
        assert torch.equal(split(x, cond, t), model(x, cond, t))


@pytest.mark.parametrize("model,dtype", [(m, d) for m in ("unet", "unet_fused", "nafnet")
                                         for d in (torch.float32, torch.bfloat16)] + [("unet_int8", torch.float32)])
def test_count_flops_on_the_card_equals_the_cpu(cuda, model, dtype):
    """``utils/flops.py`` counts the same operators on the card (cuDNN's
    convolutions, the backward on the autograd engine's device thread, the
    ln2d kernel opaque in the NAFNet, ``_int_mm`` in the int8 UNet) as on
    the CPU, forward and forward + backward, exact and padded."""
    from midd_tpu_torch import config
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion
    from midd_tpu_torch.train.recipes import TINY_NAFNET, TINY_UNET
    from midd_tpu_torch.utils import flops

    def build():
        if model == "nafnet":
            return EnhancedNAFNet(TINY_NAFNET)
        return UNetDiffusion(config.DiffusionUNetConfig(**TINY_UNET), fuse_updown=model == "unet_fused",
                             use_flash=False, quant=model == "unet_int8")

    def counts(device):
        net = build().to(device)
        net.compute_dtype = dtype
        x = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(0)).to(device)
        t = torch.full((2,), 7, dtype=torch.long, device=device)
        args = (x,) if model == "nafnet" else (x, x, t)
        with torch.no_grad():
            fwd = [flops.count_flops(net, *args, lane_pad=pad) for pad in (None, (64, 16))]
        if model == "unet_int8":
            return fwd
        return fwd + [flops.count_flops(lambda: net(*args).float().square().mean().backward(), lane_pad=pad)
                      for pad in (None, (64, 16))]

    got = counts(cuda)
    assert got == counts("cpu") and all(n > 0 for n in got)
