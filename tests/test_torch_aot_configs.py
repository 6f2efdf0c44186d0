"""Pinned serving programs in the int8, batched and load-adaptive
configuration (``EngineConfig(quantize_int8="static", batching=True,
adaptive_turbo=True, aot_dir=...)``, the server's ``--int8 --batching
--adaptive --aot DIR``), and the compile workers of
``midd_tpu_torch/utils/compile_cache.py``.

(a) A toy of one static ``QuantConv2d`` whose weights and scale ride in a
    packed state, pinned in this process in both forms of the int8
    product: ``int8_conv2d_plain`` (which CPU tensors take) and the card's
    ``int8_conv2d_int_mm`` (``torch._int_mm`` runs on the CPU too). Each
    equals eager bit for bit, and new scales through the state change the
    output with no recompile.
(b) The compile worker's engine does not calibrate (its scales are program
    inputs), and its module, given the calling engine's packed state,
    computes that engine's eager path bit for bit; ``pin_all`` runs at most
    ``pin_workers`` workers at once and queues the rest; a pin's models are
    named in ``PATH_MODELS``, and a name the engine lacks raises.
(c) In a subprocess under its own timeout (``tests/_torch_aot_configs_worker.py``,
    started at the module's first test): the ``_small`` engine with static
    int8, bucket 2 and adaptive turbo; ``pin_all`` compiles ``diffusion``
    and ``turbo@hybrid`` at batch 2, a second ``pin_all`` loads them: warm
    equals cold bit for bit, both within the int8 rollout gates of the eager
    port engine (which ``tests/test_torch_qconv.py::
    test_static_int8_engine_matches_the_jax_engine`` holds to the JAX engine
    at static int8, so no JAX engine is built here).
(d) The pin keys of every int8 mode and of the turbo tier differ; the
    server's flags reach the configuration.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from midd_tpu_torch.ops import qconv
from midd_tpu_torch.serve import engine as engine_module
from midd_tpu_torch.serve.engine import InferenceEngine, _PinEngine, pin_module
from midd_tpu_torch.utils import compile_cache as cc
from tests._torch_aot_configs_worker import PINNED, int8_config, toy_qconv_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND_TRIP_TIMEOUT_S = 600
# int8 rollouts are chaotic: a last-bit change of an fp32 sum (Inductor
# orders the elementwise chains its own way) flips an activation's int8
# rounding by a whole step, which reaches every later layer. The JAX
# package's int8 wiring bounds (tests/test_qconv.py), as chip_smoke.py's
# phase 12 and 22b hold its int8 rollouts.
INT8_ROLLOUT_MAX, INT8_ROLLOUT_CORR = 0.1, 0.995


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """The worker's process, started at the module's first test: the tests
    before (c) run while it compiles."""
    root = tmp_path_factory.mktemp("aot_int8")
    np.save(root / "x.npy", np.random.default_rng(21).random((2, 1, 16, 16), dtype=np.float32))
    job = {"aot_dir": str(root / "pins"), "cache_dir": str(root / "cache"), "input": str(root / "x.npy"),
           "outputs": str(root / "outs.npz"), "reports": str(root / "reports.json")}
    with open(root / "job.json", "w") as f:
        json.dump(job, f)
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_aot_configs_worker.py"),
                             str(root / "job.json")], cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    result = {}

    def finish():
        if not result:
            try:
                _, err = proc.communicate(timeout=ROUND_TRIP_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            assert proc.returncode == 0, err[-6000:]
            with open(job["reports"]) as f:
                result["reports"] = json.load(f)
            result["outs"] = dict(np.load(job["outputs"]))
        return result

    yield finish
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start_round_trip(round_trip):
    """Every test of the module requests the round trip, so its process
    starts with the first one."""


# -- (a) the int8 product inside a pinned program --------------------------------


def _card_form(xq, wq, stride, padding):
    return qconv.int8_conv2d_int_mm(xq, wq, stride, padding)


@pytest.mark.parametrize("form", ["plain", "int_mm"])
def test_static_qconv_pin_equals_eager_in_both_forms(form, tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "cache"))
    calls = []
    if form == "int_mm":
        # CPU tensors take the plain form; this toy takes the card's
        monkeypatch.setattr(qconv, "int8_conv2d", lambda *a: calls.append(1) or _card_form(*a))
    module, (flats, x) = toy_qconv_build()
    program, loaded = cc.pin_or_load(module, (flats, x), str(tmp_path / "toy.pt2"))
    assert loaded is False
    if form == "int_mm":
        assert calls, "the export traced the card's form"
        targets = {str(n.target) for n in cc.export(module, (flats, x)).graph.nodes if n.op == "call_function"}
        assert "aten._int_mm.default" in targets, targets
    with torch.inference_mode():
        want = module(flats, x)
        got = program(flats, x)
        assert torch.equal(got, want)
        # another scale through the state: the same program, another output
        key, off, _ = module.layout["conv.act_absmax"]
        other = {**flats, key: flats[key].clone()}
        other[key][off] = 3.0
        want2, got2 = module(other, x), program(other, x)
    assert torch.equal(got2, want2)
    assert not torch.equal(got2, got)
    assert cc.pin_or_load(module, (flats, x), str(tmp_path / "toy.pt2"))[1] is True


# -- (b) the compile workers -----------------------------------------------------


def test_pin_worker_does_not_calibrate_and_takes_the_callers_scales(monkeypatch):
    caller = InferenceEngine(int8_config(warmup=False, persistent_cache=False))
    try:
        assert set(caller.calibration_ms) == {"diffusion", "hybrid"}
        flats, _ = caller._pin_jobs((2,), "/nonexistent")

        def refuse(*args, **kwargs):
            raise AssertionError("a compile worker calibrated")

        monkeypatch.setattr(engine_module, "calibrate_unet_rollout", refuse)
        worker = _PinEngine(int8_config(warmup=False, persistent_cache=False, batching=False))
        assert worker.calibration_ms == {} and worker.int8_scales == {}
        worker.close()
        x = torch.from_numpy(np.random.default_rng(5).random((2, 1, 16, 16), dtype=np.float32))
        for name in PINNED:
            module, (own, example) = pin_module(caller.cfg, name, 2)
            assert example.shape == x.shape
            assert {k: (t.dtype, t.shape) for k, t in own.items()} == \
                {k: (t.dtype, t.shape) for k, t in flats.items()}
            assert not all(torch.equal(own[k], flats[k]) for k in flats), "placeholder scales, not the caller's"
            table = caller._turbo_paths if name.startswith("turbo@") else caller._paths
            with torch.inference_mode():
                assert torch.equal(module(flats, x), table[name.split("@")[-1]](x)), name
    finally:
        caller.close()


def test_pin_workers_are_bounded_by_the_cores():
    assert cc.pin_workers(12, cores=8) == 4
    assert cc.pin_workers(3, cores=8) == 3
    assert cc.pin_workers(12, cores=1) == 1
    assert cc.pin_workers(1, cores=32) == 1
    assert 1 <= cc.pin_workers(12) <= max(1, len(os.sched_getaffinity(0)) // cc.CORES_PER_PIN_WORKER)


def test_pin_all_queues_workers_past_its_bound(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "cache"))
    _, example = toy_qconv_build()
    jobs = [(str(tmp_path / f"toy{i}.pt2"), example, toy_qconv_build) for i in range(2)]
    # more cores a worker than the host has: one worker at a time
    monkeypatch.setattr(cc, "CORES_PER_PIN_WORKER", len(os.sched_getaffinity(0)) + 1)
    assert cc.pin_workers(len(jobs)) == 1
    results = cc.pin_all(jobs)
    first, second = (info for _, _, info in results)
    assert [loaded for _, loaded, _ in results] == [False, False]
    for info in (first, second):
        assert info["export_s"] > 0 and info["compile_s"] > 0 and info["worker_s"] >= info["compile_s"]
        assert info["compile_threads"] == str(len(os.sched_getaffinity(0)))  # one worker ran at a time
    assert second["queued_s"] >= first["worker_s"], (first, second)
    module, (flats, x) = toy_qconv_build()
    with torch.inference_mode():
        want = module(flats, x)
        for program, _, _ in results:
            assert torch.equal(program(flats, x), want)
    again = cc.pin_all(jobs)
    assert [loaded for _, loaded, _ in again] == [True, True] and all("load_s" in i for _, _, i in again)


def test_a_pins_models_are_named_and_a_missing_name_raises(monkeypatch):
    eng = InferenceEngine(int8_config(quantize_int8=False, warmup=False, persistent_cache=False))
    try:
        module, _ = eng._pinned("nafnet", 1)
        assert list(module.models) == ["naf"] and "naf" not in module.others
        monkeypatch.setitem(engine_module.PATH_MODELS, "nafnet", ("nafnet_renamed",))
        with pytest.raises(KeyError, match="nafnet_renamed"):
            eng._pinned("nafnet", 1)
    finally:
        eng.close()


def test_aot_dispatch_counts_what_each_program_served():
    dispatch = cc.AotDispatch(lambda x: x - 1, {2: lambda x: x + 1})
    assert dispatch.served == {2: 0}
    for b in (2, 1, 2):
        dispatch(torch.zeros(b, 1, 2, 2))
    assert dispatch.served == {2: 2} and dispatch.dropped == 0


def test_health_reports_the_batcher_and_the_pins():
    eng = InferenceEngine(int8_config(quantize_int8=False, warmup=False, persistent_cache=False))
    try:
        health = eng.health()
        assert set(health["batching"]) >= {"requests", "batches", "turbo_batches", "rejected"}
        assert "aot" not in health, "an engine without aot_dir pins nothing"
        eng._aot["nafnet"] = cc.AotDispatch(lambda x: x, {2: lambda x: x})
        eng._aot["nafnet"](torch.zeros(2, 1, 16, 16))
        assert eng.health()["aot"] == {"served": {"nafnet": {2: 1}}, "dropped": 0}
    finally:
        eng.close()


# -- (d) keys and flags ----------------------------------------------------------


def test_pin_keys_differ_by_int8_mode_and_turbo_tier():
    keys = {}
    for quant in (False, "static", "dynamic"):
        for turbo in (False, True):
            eng = InferenceEngine(int8_config(quantize_int8=quant, adaptive_turbo=turbo, warmup=False,
                                              persistent_cache=False))
            try:
                _, jobs = eng._pin_jobs((2,), "/pins")
            finally:
                eng.close()
            paths = {f"{name}_b{b}": os.path.basename(job[0]) for name, b, job in jobs}
            assert ("turbo@diffusion_b2" in paths) == turbo and ("turbo@hybrid_b2" in paths) == turbo
            keys[quant, turbo] = paths
    for name in ("diffusion_b2", "hybrid_b2", "nafnet_b2", "expert_b2"):
        assert len({paths[name] for paths in keys.values()}) == 6, name


def test_server_flags_reach_the_pinned_int8_configuration():
    from midd_tpu_torch.serve import server

    _, cfg = server.config_from_args(["--img-size", "256", "--int8", "--batching", "--buckets", "1,2",
                                      "--adaptive", "--aot", "/pins", "--device", "cpu"])
    assert (cfg.img_size, cfg.quantize_int8, cfg.batching, cfg.batch_buckets, cfg.adaptive_turbo, cfg.aot_dir) == \
        (256, "static", True, (1, 2), True, "/pins")


# -- (c) the round trip ----------------------------------------------------------


def test_cold_pins_compile_and_warm_pins_load(round_trip):
    reports = round_trip()["reports"]
    assert sorted(reports["calibration_ms"]) == ["diffusion", "hybrid"]
    assert [p.split("_b2_")[0] for p in reports["pins"]] == list(PINNED)
    assert all(not r["loaded"] and r["export_s"] > 0 and r["compile_s"] > 0 for r in reports["cold"])
    assert all(r["loaded"] and r["load_s"] > 0 for r in reports["warm"])


@pytest.mark.parametrize("name", PINNED)
def test_warm_pin_equals_cold_and_eager_within_int8_gates(round_trip, name):
    outs = round_trip()["outs"]
    cold, warm, eager = outs[f"cold/{name}"], outs[f"warm/{name}"], outs[f"eager/{name}"]
    assert cold.shape == (2, 1, 16, 16) and np.isfinite(cold).all()
    assert np.array_equal(warm, cold)
    assert np.abs(warm - eager).max() < INT8_ROLLOUT_MAX
    assert np.corrcoef(warm.ravel(), eager.ravel())[0, 1] > INT8_ROLLOUT_CORR
