"""The port's serving engine and HTTP server.

(a) The JAX engine and the port's engine load the same ``.pth`` files (made
    from JAX-initialised weights with ``state_dict_from_jax``) at a tiny
    config, exact fp32, with the default (0,2,6,7)-style refresh on both
    rollouts; all four per-path outputs agree to 1e-3.
(b) The port server's HTTP contract, mirroring tests/test_serving.py:
    ``GET /ui``, and 503 with ``Retry-After`` when bounded admission refuses.
(c) Importing the port, its server and ``chip_smoke.py`` loads no JAX and
    no ``midd_tpu`` module.
"""

import base64
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu import models as jm
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.convert.from_jax import state_dict_from_jax
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.serve.server import make_server
from tests.torch_port_util import image, jax_init, perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNET = dict(model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1,), time_emb_dim=16)
NAF = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))


def _tiny(cfg):
    return dict(
        img_size=32,
        nafnet_cfg=cfg.NAFNetConfig(**NAF),
        diffusion_cfg=cfg.DiffusionUNetConfig(**UNET),
        expert_cfg=cfg.ExpertConfig(base_channels=8),
        router_cfg=cfg.RouterConfig(base_c=8),
        fusion_cfg=cfg.FusionConfig(base_c=16),
        warmup=False,
    )


def _small(cfg):
    """``_tiny`` at 16², with a 2-step rollout over a 6-step schedule."""
    return {**_tiny(cfg), "img_size": 16, "diffusion_steps": 2, "hybrid_diffusion_steps": 2,
            "schedule_cfg": cfg.ScheduleConfig(noise_steps=6)}


def _write_checkpoints(ckpt_dir, rng):
    x = jnp.zeros((1, 32, 32, 1))
    t = jnp.zeros((1,), jnp.int32)

    def sd(model, *args):
        return state_dict_from_jax(perturb(jax_init(model, *args, seed=int(rng.integers(1 << 30))), rng))

    unet = jm.UNetDiffusion(jcfg.DiffusionUNetConfig(**UNET))
    naf = jm.EnhancedNAFNet(jcfg.NAFNetConfig(**NAF))
    files = {
        "diffusion": sd(unet, x, x, t),
        "nafnet": sd(naf, x),
        "expert": sd(jm.ExpertDenoiser(jcfg.ExpertConfig(base_channels=8)), x),
    }
    hybrid = {}
    for prefix, part in (("nafnet", sd(naf, x)), ("diffusion_unet", sd(unet, x, x, t)),
                         ("router", sd(jm.NoiseAnalyzer(jcfg.RouterConfig(base_c=8)), x)),
                         ("fusion", sd(jm.FusionModule(jcfg.FusionConfig(base_c=16)), x, x, x))):
        hybrid.update({f"{prefix}.{k}": v for k, v in part.items()})
    files["hybrid"] = hybrid
    for name, state in files.items():
        torch.save({"model_state_dict": state, "epoch": 1},
                   os.path.join(ckpt_dir, f"{name}.pth"))


def test_port_engine_matches_jax_engine_on_pth_checkpoints(tmp_path):
    rng = np.random.default_rng(11)
    _write_checkpoints(str(tmp_path), rng)
    exact = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False, ckpt_dir=str(tmp_path))
    jeng = JEngine(JEngineConfig(**_tiny(jcfg), **exact, persistent_cache=False))
    teng = InferenceEngine(EngineConfig(**_tiny(tcfg), **exact, device="cpu"))
    assert teng.diffusion_eps_reuse == jeng.diffusion_eps_reuse == (0, 2, 6, 7)
    assert teng.hybrid_eps_reuse == jeng.hybrid_eps_reuse == (0, 2, 6, 7)
    assert teng.meta["nafnet"] == {"epoch": 1}
    x = image(rng, 1, 32, 32, 1)
    for name in MODEL_NAMES:
        want = np.asarray(jeng.fns[name](jnp.asarray(x)))
        got = teng.fns[name](x)
        assert got.shape == want.shape == (1, 32, 32, 1), name
        np.testing.assert_allclose(got, want, atol=1e-3, err_msg=name)


def test_hybrid_without_backends_falls_back_to_standalone(tmp_path):
    """A trainer-style hybrid file (router + fusion only) rides the
    standalone NAFNet and UNet."""
    rng = np.random.default_rng(5)
    _write_checkpoints(str(tmp_path), rng)
    path = os.path.join(str(tmp_path), "hybrid.pth")
    ckpt = torch.load(path, weights_only=False)
    ckpt["model_state_dict"] = {
        k: v for k, v in ckpt["model_state_dict"].items() if k.split(".")[0] in ("router", "fusion")
    }
    torch.save(ckpt, path)
    eng = InferenceEngine(EngineConfig(**_tiny(tcfg), ckpt_dir=str(tmp_path), device="cpu"))
    assert np.isfinite(eng.fns["hybrid"](image(rng, 1, 32, 32, 1))).all()


def test_orbax_directory_names_the_roadmap_item(tmp_path):
    os.makedirs(tmp_path / "diffusion")
    with pytest.raises(NotImplementedError, match="orbax_bridge.py to-pth"):
        InferenceEngine(EngineConfig(**_tiny(tcfg), ckpt_dir=str(tmp_path), device="cpu"))


def test_exact_mode_and_defaults_in_serving_mode():
    kw = {**_tiny(tcfg), "ckpt_dir": "/nonexistent", "device": "cpu"}
    default = InferenceEngine(EngineConfig(**kw, diffusion_steps=8, hybrid_diffusion_steps=8))
    mode = default.serving_mode()
    assert mode["exact"] is False and mode["diffusion_eps"] == [0, 2, 6, 7]
    assert mode["diffusion_eval_dtype"] == mode["hybrid_rollout_eval_dtype"] == "bfloat16"
    exact = InferenceEngine(EngineConfig(
        **kw, turbo_eps_reuse=1, hybrid_turbo_eps_reuse=1,
        diffusion_eval_bf16=False, hybrid_rollout_bf16=False,
    ))
    assert exact.serving_mode()["exact"] is True


def test_engine_refuses_fields_outside_the_slice():
    for field in ("aot_dir", "persistent_cache", "cache_dir"):
        with pytest.raises(TypeError):
            EngineConfig(**{field: True})


# the layouts the port computes, whatever the config's nafnet_s2d says
PLAIN_LAYOUT = {"nafnet_s2d": False, "unet_fused_updown": True, "unet_s2d_stage0": False}


def _nested_keys(d, prefix=""):
    """Every key of a nested dict, as dotted paths."""
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= _nested_keys(v, prefix + k + ".")
    return keys


@pytest.mark.parametrize("extra", [
    {},
    dict(batching=True, fused_request=True, adaptive_turbo=True, adaptive_queue_depth=5,
         adaptive_diffusion_eps=2, max_queue_depth=4),
])
def test_serving_mode_new_keys_match_the_jax_engine(extra):
    kw = {**_tiny(tcfg), "ckpt_dir": "/nonexistent", **extra}
    teng = InferenceEngine(EngineConfig(**kw, device="cpu"))
    jeng = JEngine(JEngineConfig(**{**kw, **_tiny(jcfg)}, persistent_cache=False))
    try:
        got, want = teng.serving_mode(), jeng.serving_mode()
        assert _nested_keys(got) == _nested_keys(want)
        # values differ on purpose only where the port runs another path:
        # the "layout" restructurings (the port computes the plain layouts)
        for key in set(want) - {"layout"}:
            assert got[key] == want[key], key
        assert got["layout"] == PLAIN_LAYOUT
    finally:
        teng.close()
        if jeng.batcher is not None:
            jeng.batcher.stop()


# -- (b) HTTP contract -------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    engine = InferenceEngine(EngineConfig(
        **{**_tiny(tcfg), "warmup": True}, diffusion_steps=3, hybrid_diffusion_steps=3,
        schedule_cfg=tcfg.ScheduleConfig(noise_steps=10), ckpt_dir="/nonexistent", device="cpu",
    ))
    srv = make_server("127.0.0.1", 0, engine=engine)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _request(server, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(server, timeout=120)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _png(size=(40, 30)):
    arr = (np.random.default_rng(0).random((size[1], size[0])) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def _multipart(png):
    boundary = "testboundary123"
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; filename="x.png"\r\n'
        f"Content-Type: image/png\r\n\r\n"
    ).encode() + png + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def test_root_contract(server):
    status, body = _request(server, "GET", "/")
    assert status == 200
    assert body["status"] == "running"
    assert body["endpoints"] == {"denoise": "/denoise", "health": "/health"}


def test_health_contract(server):
    status, body = _request(server, "GET", "/health")
    assert status == 200 and body["status"] == "healthy"
    assert body["device"] == "cpu"
    assert body["models_loaded"] == {n: True for n in MODEL_NAMES}
    assert body["serving_mode"]["steps"] == [3, 3]


@pytest.mark.parametrize("form", ["multipart", "raw"])
def test_denoise_contract(server, form):
    png = _png()
    body, headers = _multipart(png) if form == "multipart" else (png, {"Content-Type": "image/png"})
    status, out = _request(server, "POST", "/denoise", body, headers)
    assert status == 200
    assert set(out) == set(MODEL_NAMES)
    for name, b64 in out.items():
        assert b64 is not None, f"{name} returned null"
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        assert img.size == (40, 30) and img.mode == "L"


def test_denoise_bad_request_is_500_with_detail(server):
    body, headers = _multipart(b"not a png")
    status, out = _request(server, "POST", "/denoise", body, headers)
    assert status == 500 and "detail" in out


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/other")])
def test_unknown_route_is_404(server, method, path):
    status, out = _request(server, method, path, b"" if method == "POST" else None)
    assert status == 404 and out == {"detail": "Not Found"}


def test_server_cli_flags_build_the_engine_config(monkeypatch):
    """The serving flags of the JAX server's CLI, with its semantics."""
    from midd_tpu_torch.serve import server as srv

    seen = {}
    monkeypatch.setattr(srv, "serve_forever", lambda host, port, engine_config: seen.update(cfg=engine_config))
    srv.main(["--batching", "--adaptive", "--max-queue", "6", "--queue-depth", "5", "--buckets", "1,2",
              "--fused", "--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.batching, cfg.adaptive_turbo, cfg.max_queue_depth, cfg.adaptive_queue_depth) == (True, True, 6, 5)
    assert cfg.batch_buckets == (1, 2) and cfg.fused_request is True and cfg.device == "cpu"
    srv.main([])
    cfg = seen["cfg"]
    assert (cfg.batching, cfg.adaptive_turbo, cfg.max_queue_depth, cfg.batch_buckets, cfg.fused_request) == (
        False, False, None, "auto", None)


def test_ui_page(server):
    conn = http.client.HTTPConnection(server, timeout=120)
    conn.request("GET", "/ui")
    resp = conn.getresponse()
    page = resp.read().decode()
    conn.close()
    assert resp.status == 200 and resp.getheader("Content-Type").startswith("text/html")
    assert "/denoise" in page and "<html" in page


def test_full_queue_answers_503_with_retry_after():
    """Bounded admission: with one request on the device (a slow stub path)
    and one waiting, the others are refused with 503 and Retry-After: 1."""
    eng = InferenceEngine(EngineConfig(**_small(tcfg), ckpt_dir="/nonexistent", device="cpu",
                                       batching=True, batch_buckets=(1,), max_queue_depth=1))
    expert = eng._paths["expert"]

    def slow_expert(x):
        time.sleep(0.5)
        return expert(x)

    eng._paths["expert"] = slow_expert
    srv = make_server("127.0.0.1", 0, engine=eng)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    body, headers = _multipart(_png())

    def post(_):
        conn = http.client.HTTPConnection(addr, timeout=120)
        conn.request("POST", "/denoise", body=body, headers=headers)
        resp = conn.getresponse()
        out = resp.status, resp.getheader("Retry-After"), json.loads(resp.read())
        conn.close()
        return out

    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            answers = list(pool.map(post, range(6), timeout=120))
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        eng.close()
    refused = [a for a in answers if a[0] == 503]
    assert refused and len(refused) == eng.batcher.stats["rejected"]
    assert all(a[1] == "1" and "detail" in a[2] for a in refused)
    for status, _, out in answers:
        if status != 503:
            assert status == 200 and all(out[n] is not None for n in MODEL_NAMES)


def test_failed_path_answers_null_and_others_still_answer():
    """Per-path isolation: a path that raises answers null."""
    eng = InferenceEngine(EngineConfig(
        **_tiny(tcfg), diffusion_steps=3, hybrid_diffusion_steps=3,
        schedule_cfg=tcfg.ScheduleConfig(noise_steps=10), ckpt_dir="/nonexistent", device="cpu",
    ))

    def boom(x):
        raise RuntimeError("injected")

    eng._paths["expert"] = boom
    out = eng.process_all(image(np.random.default_rng(0), 1, 32, 32, 1), (32, 32))
    assert out["expert"] is None
    assert all(out[n] is not None for n in MODEL_NAMES if n != "expert")


# -- (c) no JAX in the port ----------------------------------------------------


_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import midd_tpu_torch
walked = set()
for m in pkgutil.walk_packages(midd_tpu_torch.__path__, "midd_tpu_torch."):
    importlib.import_module(m.name)
    walked.add(m.name)
want = {{"midd_tpu_torch." + n for n in ("serve.server", "ops.flash_attention", "train.data",
        "train.losses", "train.metrics", "train.trainer", "train.recipes", "utils.checkpoint",
        "serve.batching", "serve.static_ui", "inference", "evaluate", "native", "utils.flops")}}
assert want <= walked, sorted(want - walked)
{extra}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "midd_tpu"))
assert not bad, bad
print("clean")
"""


@pytest.mark.parametrize("extra", ["", "import chip_smoke", "import bench_train_torch"])
def test_port_imports_no_jax(extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK.format(repo=REPO, extra=extra)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
