"""The hand-written flash-attention kernels on the card (forward; backward dq
and dk/dv): agreement with their plain versions, the launch counts,
gradients through ``mha``, and the wrappers' refusals. Marked ``cuda``;
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
    (3, 777, 128, torch.float32),
    (1, 1, 1, torch.float32),
    (4, 130, 40, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, bh, n, d, dtype):
    q, k, v = _qkv(bh, n, d, dtype)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float())
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (bh, n)
    # bf16: two bf16 ulps of the largest output (reasons in chip_smoke.py)
    tol = 2.0 ** -7 * o_ref.abs().max().item() if dtype == torch.bfloat16 else 1e-5
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
        big = torch.zeros(1, 8, 160, device="cuda")
        fa.flash_attention(big, big, big)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("bh,n,d,dtype", [
    (2, 4096, 96, torch.float32),
    (2, 4096, 96, torch.bfloat16),
    (2, 1000, 64, torch.bfloat16),
    (3, 77, 128, torch.float32),
    (1, 1, 1, torch.float32),
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
