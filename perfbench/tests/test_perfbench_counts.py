"""The benchmark's frozen arithmetic: its FLOP counter against the port's
``utils/flops.py::count_flops`` on the same networks at 64x64 (the port's
UNet with its upsamplers unfused, which is the reference's form), its
kernel bounds against the ones PERF.md's kernel table was measured
against, and the trace arithmetic."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import yardstick
from perfbench.reference import models as ref
from perfbench.reference import serve

CFG = {**json.loads((Path(__file__).parents[1] / "configs" / "xray512_b8.json").read_text()), "img_size": 64}


def _port():
    from midd_tpu_torch import config
    from midd_tpu_torch.models.direct_unet import ExpertDenoiser
    from midd_tpu_torch.models.hybrid import FusionModule, NoiseAnalyzer
    from midd_tpu_torch.models.nafnet import EnhancedNAFNet
    from midd_tpu_torch.models.unet_diffusion import UNetDiffusion

    return {"diffusion": UNetDiffusion(config.SERVE_DIFFUSION, fuse_updown=False, use_flash=False),
            "nafnet": EnhancedNAFNet(config.SERVE_NAFNET), "expert": ExpertDenoiser(config.SERVE_EXPERT),
            "router": NoiseAnalyzer(config.RouterConfig()), "fusion": FusionModule(config.FusionConfig())}


@pytest.mark.parametrize("name", ["diffusion", "nafnet", "expert", "router", "fusion"])
def test_counts_equal_the_ports(name):
    from midd_tpu_torch.utils.flops import count_flops

    port = _port()[name].eval()
    ours = ref.build(CFG, "meta")
    ours = {**ours, "router": ours["hybrid"].router, "fusion": ours["hybrid"].fusion}[name]
    x = torch.rand(1, 1, 64, 64)
    xm = torch.empty(1, 1, 64, 64, device="meta")
    with torch.no_grad():
        if name == "diffusion":
            t = torch.tensor([48])
            want = count_flops(port, x, x, t)
            got = yardstick.count_flops(ours, xm, xm, t.to("meta"))
        elif name == "fusion":
            want = count_flops(port, x, x, x)
            got = yardstick.count_flops(ours, xm, xm, xm)
        else:
            want, got = count_flops(port, x), yardstick.count_flops(ours, xm)
    assert got == want > 0


def test_request_flops_add_up():
    m = ref.build(CFG, "meta")
    x = torch.empty(1, 1, 64, 64, device="meta")
    with torch.no_grad():
        evals = len(CFG["refresh"]) * yardstick.count_flops(m["diffusion"], x, x, torch.zeros(1, dtype=torch.long,
                                                                                           device="meta"))
        tf32 = (2 * yardstick.count_flops(m["nafnet"], x) + yardstick.count_flops(m["expert"], x)
                + yardstick.count_flops(m["hybrid"].router, x) + yardstick.count_flops(m["hybrid"].fusion, x, x, x))
    assert yardstick.request_flops(CFG) == {"bfloat16": 2 * evals, "tf32": tf32}
    assert len(serve.timesteps(50, 8)) == 9


def test_kernel_bounds():
    # PERF.md's kernel table: flash (2, 4096, 96) bf16 0.0130 ms, ops-bound;
    # ln2d fp32 (1, 32, 512, 512) 0.0200 ms, bytes-bound
    ops, nbytes, peak = yardstick.flash_fwd_cost(2, 4096, 96, "bfloat16")
    assert yardstick.bound_s(ops, nbytes, peak) == pytest.approx(13.03e-6, rel=1e-3) and ops / peak > nbytes / 3.35e12
    ops, nbytes, peak = yardstick.ln2d_cost(1, 32, 512, 512, "float32")
    assert yardstick.bound_s(ops, nbytes, peak) == pytest.approx(20.03e-6, rel=1e-3) and ops / peak < nbytes / 3.35e12
    assert yardstick.roofline_pct([(ops, nbytes, peak)] * 3, 3, 3 * 40e-6) == pytest.approx(50.08, rel=1e-3)
    assert yardstick.roofline_pct([], 3, 1.0) is None


def test_union_and_kinds():
    covered, gaps = yardstick.union_s([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)])
    assert covered == pytest.approx(3.0) and gaps == [(2.0, 3.0)]
    assert yardstick.kind("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 6>(...)").startswith("flash")
    assert yardstick.kind("void ln2d_cl_kernel<float>(...)").startswith("ln2d")
    assert yardstick.kind("sm90_xmma_fprop_implicit_gemm_bf16") == "conv / gemm (cuDNN, cuBLAS)"
