"""Pinned serving programs and the persistent compile cache of the port
(``midd_tpu_torch/utils/compile_cache.py``, the engine's ``aot_dir``,
``persistent_cache``, ``cache_dir`` and the server's ``--aot``).

(a) Units, on a toy module that calls both custom ops (``midd::flash_fwd``,
    ``midd::ln2d``) and shares one compiled package: the cache directory
    kept or set, the fingerprint's fields, a loaded program against eager,
    a corrupt pin recompiled, ``AotDispatch``'s fallback, the exported
    graph's op nodes, and the ops' fakes against their implementations.
(b) One engine round trip at ``tests/test_torch_serve.py``'s ``_small``
    widths, exact fp32, flash attention, on JAX-initialised ``.pth``
    checkpoints, in a subprocess (``tests/_torch_aot_worker.py``, under a
    timeout: a hang fails its tests, not the suite), while the JAX engine
    computes the same paths here: a cold start compiles every pin, a warm
    start loads them all and serves the cold start's numbers, both within
    1e-5 of the eager port engine and within ``test_torch_serve``'s 1e-3
    of the JAX engine; another schedule of the same step count recompiles
    and serves its own numbers.
(c) ``aot_dir`` with a mesh raises; ``--aot`` reaches ``aot_dir``.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from midd_tpu import config as jcfg
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.ops import flash_attention as fa
from midd_tpu_torch.ops import ln2d as ln
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.utils import compile_cache as cc
from tests.test_torch_serve import _small, _tiny, _write_checkpoints
from tests.torch_port_util import image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND_TRIP_TIMEOUT_S = 900
# the round trip's two schedules: _small's, and another of the same 2-step rollout
SCHEDULES = {"first": {"noise_steps": 6}, "other": {"noise_steps": 6, "beta_end": 0.05}}


# -- (a) units -----------------------------------------------------------------


class Toy(torch.nn.Module):
    """A convolution, LayerNorm2d and flash attention: both custom ops, its
    weight an input as the engine's pins take theirs."""

    def forward(self, w, x):
        y = torch.nn.functional.conv2d(x, w, padding=1)
        y = ln.LayerNorm2dFn.apply(y, torch.linspace(0.5, 1.5, 8), torch.linspace(-0.1, 0.1, 8), 1e-6)
        q = y.flatten(2).transpose(1, 2).reshape(2, -1, 4).contiguous()
        return fa.FlashAttention.apply(q, q, q).sum(-1) + y.mean()


def _toy_args(rng, batch=1):
    return (torch.from_numpy(rng.standard_normal((8, 1, 3, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((batch, 1, 8, 8)).astype(np.float32)))


@pytest.fixture(scope="module")
def toy_pin(tmp_path_factory):
    """(program, path, example args): the toy compiled once, its compiler
    cache under the test's directory."""
    root = tmp_path_factory.mktemp("toy")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCHINDUCTOR_CACHE_DIR", str(root / "cache"))
        args = _toy_args(np.random.default_rng(0))
        path = str(root / "toy.pt2")
        program, loaded = cc.pin_or_load(Toy(), args, path)
        assert loaded is False
        yield program, path, args


def test_enable_persistent_cache_keeps_a_set_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "set"))
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    assert cc.enable_persistent_cache() == str(tmp_path / "set")
    assert "TRITON_CACHE_DIR" not in os.environ
    mine = str(tmp_path / "mine")
    assert cc.enable_persistent_cache(mine) == mine
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == mine
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(mine, "triton")
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR")
    assert cc.enable_persistent_cache() == os.path.abspath(cc.DEFAULT_CACHE_DIR)
    assert not os.path.exists(tmp_path / "mine"), "the directory is made by the compiler, at its first write"


def test_engine_sets_its_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "app"))
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    kw = {**_tiny(tcfg), "ckpt_dir": "/nonexistent", "device": "cpu"}
    InferenceEngine(EngineConfig(**kw))  # keeps the application's
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "app")
    InferenceEngine(EngineConfig(**kw, persistent_cache=False, cache_dir=str(tmp_path / "off")))
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "app")
    InferenceEngine(EngineConfig(**kw, cache_dir=str(tmp_path / "c")))
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "c")
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "c" / "triton")


_BASE = dict(model="diffusion", batch=1, img_size=16, device="cpu", steps=(2, 2), eps=(1, 1, None, None),
             dtype=("None", False, False), quant="False", flash=True, s2d=False,
             schedule_cfg=tcfg.ScheduleConfig(noise_steps=6), resolved={"nafnet": tcfg.NAFNetConfig()},
             expert_tree="shared", weights="abc")


@pytest.mark.parametrize("field,value", [
    ("model", "nafnet"), ("batch", 2), ("img_size", 32), ("steps", (2, 3)), ("eps", (2, 1, None, None)),
    ("dtype", ("None", True, False)), ("quant", "static"), ("flash", False),
    ("schedule_cfg", tcfg.ScheduleConfig(noise_steps=6, beta_end=0.05)),
    ("resolved", {"nafnet": tcfg.NAFNetConfig(width=16)}), ("expert_tree", "expert_ftl2"), ("weights", "abd"),
])
def test_fingerprint_changes_with_each_field(field, value):
    assert cc.aot_fingerprint(**_BASE) == cc.aot_fingerprint(**_BASE)
    assert cc.aot_fingerprint(**{**_BASE, field: value}) != cc.aot_fingerprint(**_BASE)


def test_loaded_program_equals_eager(toy_pin):
    program, path, args = toy_pin
    loaded = cc.load_executable(path)
    with torch.inference_mode():
        want = Toy()(*args)
        for prog in (program, loaded):
            np.testing.assert_allclose(prog(*args).numpy(), want.numpy(), atol=1e-6)
    # the weights are inputs: other values, the same program
    other = _toy_args(np.random.default_rng(1))
    with torch.inference_mode():
        np.testing.assert_allclose(loaded(*other).numpy(), Toy()(*other).numpy(), atol=1e-6)


def test_warm_pin_loads(toy_pin):
    _, path, args = toy_pin
    program, loaded = cc.pin_or_load(Toy(), args, path)
    assert loaded is True


def test_corrupt_pin_is_recompiled_and_overwritten(toy_pin, tmp_path, monkeypatch):
    _, _, args = toy_pin
    monkeypatch.setattr(cc.log, "stream", io.StringIO())
    path = str(tmp_path / "corrupt.pt2")
    with open(path, "wb") as f:
        f.write(b"not a package")
    program, loaded = cc.pin_or_load(Toy(), args, path)
    assert loaded is False
    assert '"event": "aot_pin_broken"' in cc.log.stream.getvalue()
    assert open(path, "rb").read(2) == b"PK", "the pin is a package (a zip) again"
    assert cc.pin_or_load(Toy(), args, path)[1] is True
    with torch.inference_mode():
        np.testing.assert_allclose(program(*args).numpy(), Toy()(*args).numpy(), atol=1e-6)


def test_aot_dispatch_serves_pinned_shapes_and_falls_back(toy_pin):
    program, _, (w, x) = toy_pin
    seen = []

    def fallback(x):
        seen.append((tuple(x.shape), x.dtype))
        return x

    dispatch = cc.AotDispatch(fallback, {1: program}, bound_args=(w,), like=x)
    assert dispatch.pinned == (1,)
    with torch.inference_mode():
        np.testing.assert_allclose(dispatch(x).numpy(), Toy()(w, x).numpy(), atol=1e-6)
        assert seen == []
        x2 = _toy_args(np.random.default_rng(2), batch=2)[1]
        dispatch(x2)  # an unpinned batch size
        dispatch(torch.zeros(1, 1, 4, 4))  # another image size
        dispatch(x.double())  # another dtype
    assert seen == [((2, 1, 8, 8), torch.float32), ((1, 1, 4, 4), torch.float32), ((1, 1, 8, 8), torch.float64)]
    # an input whose size-1 channel carries another stride is read densely
    odd = x.as_strided(x.shape, (64, 1, 8, 1))  # as the engine's NHWC-to-NCHW permute leaves it
    assert odd.stride() != x.stride()
    with torch.inference_mode():
        np.testing.assert_allclose(dispatch(odd).numpy(), Toy()(w, x).numpy(), atol=1e-6)


def test_aot_dispatch_drops_a_program_that_raises(monkeypatch):
    monkeypatch.setattr(cc.log, "stream", io.StringIO())
    def broken(*args):
        raise RuntimeError("stale program")

    dispatch = cc.AotDispatch(lambda x: x + 1, {1: broken})
    x = torch.zeros(1, 1, 2, 2)
    assert torch.equal(dispatch(x), x + 1) and torch.equal(dispatch(x), x + 1)
    assert dispatch.dropped == 1 and dispatch.pinned == ()
    assert '"event": "aot_dispatch_failed"' in cc.log.stream.getvalue()


def test_exported_graph_holds_the_op_nodes():
    ep = cc.export(Toy(), _toy_args(np.random.default_rng(0)))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.midd.flash_fwd.default) == 1
    assert targets.count(torch.ops.midd.ln2d.default) == 1
    assert not ep.constants and not ep.state_dict, "the toy's weights are inputs, not constants"


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_ln2d_op_fake_matches_its_implementation(layout):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 6)).astype(np.float32))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    scale, bias = torch.linspace(0.5, 1.5, 8), torch.linspace(-0.1, 0.1, 8)
    torch.library.opcheck(torch.ops.midd.ln2d.default, (x, scale, bias, 1e-6))
    y = ln.ln2d_op(x, scale, bias, 1e-6)
    assert y.stride() == torch.empty_like(x).stride()
    assert torch.equal(y, ln.ln2d_plain(x, scale, bias, 1e-6))


def test_flash_op_fake_matches_its_implementation():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)) for _ in range(3))
    torch.library.opcheck(torch.ops.midd.flash_fwd.default, (q, k, v))
    o, lse = fa.flash_fwd_op(q, k, v)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


# -- (b) the engine round trip -------------------------------------------------


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """The worker's reports and outputs, and the JAX engine's outputs on
    the same checkpoints and input (computed while the worker runs)."""
    root = tmp_path_factory.mktemp("aot")
    rng = np.random.default_rng(20)
    ckpt_dir = root / "ckpt"
    ckpt_dir.mkdir()
    _write_checkpoints(str(ckpt_dir), rng)
    x = image(rng, 1, 16, 16, 1)
    np.save(root / "x.npy", x)
    job = {"ckpt_dir": str(ckpt_dir), "aot_dir": str(root / "pins"), "cache_dir": str(root / "cache"),
           "input": str(root / "x.npy"), "schedules": SCHEDULES,
           "outputs": str(root / "outs.npz"), "reports": str(root / "reports.json")}
    with open(root / "job.json", "w") as f:
        json.dump(job, f)
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_aot_worker.py"),
                             str(root / "job.json")], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        exact = dict(diffusion_eval_bf16=False, hybrid_rollout_bf16=False, turbo_eps_reuse=1,
                     hybrid_turbo_eps_reuse=1, ckpt_dir=str(ckpt_dir), persistent_cache=False)
        jeng = JEngine(JEngineConfig(**_small(jcfg), **exact))
        want = {name: np.asarray(jeng.fns[name](jnp.asarray(x))) for name in MODEL_NAMES}
        _, err = proc.communicate(timeout=ROUND_TRIP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-6000:]
    with open(job["reports"]) as f:
        reports = json.load(f)
    outs = dict(np.load(job["outputs"]))
    events = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    return {"reports": reports, "outs": outs, "jax": want, "events": events, "aot_dir": job["aot_dir"]}


def _pins():
    return sorted(f"{name}_b1" for name in MODEL_NAMES)


def test_cold_start_compiles_every_pin(round_trip):
    report = round_trip["reports"]["cold"]
    assert sorted(report) == _pins()
    assert not any(pin["loaded"] for pin in report.values())
    assert len([p for p in os.listdir(round_trip["aot_dir"]) if p.endswith(".pt2")]) == 8  # 4 a schedule


def test_warm_start_loads_every_pin_and_serves_the_cold_numbers(round_trip):
    report, outs = round_trip["reports"]["warm"], round_trip["outs"]
    assert sorted(report) == _pins() and all(pin["loaded"] for pin in report.values())
    for name in MODEL_NAMES:
        assert np.array_equal(outs[f"warm/{name}"], outs[f"cold/{name}"]), name
    loads = sorted(e["model"] for e in round_trip["events"] if e.get("event") == "aot_load")
    assert loads == sorted(MODEL_NAMES)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_pinned_engine_matches_eager_port_engine(round_trip, name):
    outs = round_trip["outs"]
    assert outs[f"warm/{name}"].shape == (1, 16, 16, 1)
    np.testing.assert_allclose(outs[f"warm/{name}"], outs[f"eager/{name}"], atol=1e-5)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_pinned_engine_matches_jax_engine(round_trip, name):
    np.testing.assert_allclose(round_trip["outs"][f"warm/{name}"], round_trip["jax"][name], atol=1e-3)


def test_other_schedule_recompiles_and_serves_its_own_numbers(round_trip):
    report, outs = round_trip["reports"]["other"], round_trip["outs"]
    assert sorted(report) == _pins() and not any(pin["loaded"] for pin in report.values())
    compiles = [e["model"] for e in round_trip["events"] if e.get("event") == "aot_compile"]
    assert sorted(compiles) == sorted(MODEL_NAMES * 2)  # the cold start's, then the other schedule's
    for name in ("diffusion", "hybrid"):
        np.testing.assert_allclose(outs[f"other/{name}"], outs[f"other_eager/{name}"], atol=1e-5)
        assert np.abs(outs[f"other/{name}"] - outs[f"warm/{name}"]).max() > 1e-3, name


# -- (c) refusals and the CLI -----------------------------------------------------


def test_aot_dir_with_a_mesh_raises(tmp_path):
    for flag in ("tensor_parallel", "data_parallel", "spatial_parallel"):
        with pytest.raises(ValueError, match="single-device"):
            InferenceEngine(EngineConfig(**_tiny(tcfg), ckpt_dir="/nonexistent", device="cpu",
                                         aot_dir=str(tmp_path), **{flag: True}), devices=["cpu"] * 2)
    assert not os.listdir(tmp_path)


def test_server_aot_flag_reaches_aot_dir():
    from midd_tpu_torch.serve import server

    assert server.config_from_args(["--aot", "/pins", "--device", "cpu"])[1].aot_dir == "/pins"
    assert server.config_from_args([])[1].aot_dir is None
