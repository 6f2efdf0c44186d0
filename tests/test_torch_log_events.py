"""The port's structured logs against the JAX package's: ``JsonLogger``'s
payload (``midd_tpu/utils/logging.py``), and the engine's log events on the
same requests, at tiny widths on demo weights, fused and per path, with a
failing fused call and a failing path, and one request to each path through
``process_one`` (its ``request`` event; its PNG is ``process_all``'s for that
path). Each event's name and its fields other than the times must be equal;
``aot_*`` events are left out (the port has no AOT pinning yet: ROADMAP.md
queue 1 item 16).
"""

import io
import json

import numpy as np
import pytest

from midd_tpu import config as jcfg
from midd_tpu.serve.engine import EngineConfig as JEngineConfig
from midd_tpu.serve.engine import InferenceEngine as JEngine
from midd_tpu.utils import logging as jlogging
from midd_tpu_torch import config as tcfg
from midd_tpu_torch.serve.engine import MODEL_NAMES, EngineConfig, InferenceEngine
from midd_tpu_torch.utils import logging as tlogging
from tests.test_torch_serve import _small
from tests.torch_port_util import image

TIMES = ("ts", "latency_ms")


@pytest.mark.parametrize("call", [("log", ("request_all",), {"mode": "per_path", "n": 3}),
                                  ("latency", ("encode", 0.0123456), {"model": "nafnet"}),
                                  ("latency", ("warmup_compile", 1.999999), {"model": "fused(all4)"})])
def test_json_logger_payload_matches_jax(monkeypatch, call):
    method, args, fields = call
    lines = []
    for module in (jlogging, tlogging):
        monkeypatch.setattr(module.time, "time", lambda: 1234.56789)
        stream = io.StringIO()
        getattr(module.JsonLogger("engine", stream), method)(*args, **fields)
        lines.append(stream.getvalue())
    assert lines[0] == lines[1]
    payload = json.loads(lines[1])
    assert list(payload)[:3] == ["ts", "component", "event"] and payload["ts"] == 1234.568
    if method == "latency":
        assert payload["latency_ms"] == round(args[1] * 1000.0, 2)
    assert tlogging.get_logger("engine") is tlogging.get_logger("engine")


def _events(text: str) -> list:
    """(component, event, fields other than the times) of each JSON log line."""
    out = []
    for line in text.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if "event" not in rec or rec["event"].startswith("aot_"):
            continue
        out.append((rec["component"], rec["event"], {k: v for k, v in rec.items()
                                                     if k not in ("component", "event", *TIMES)}))
    return out


def _boom(*args):
    raise RuntimeError("boom")


@pytest.fixture(scope="module")
def logs():
    """Each engine's events, from its build (warmup) and five requests:
    fused; fused failing (the per-path fallback); per path; each path
    through ``process_one``; per path with the expert path failing. With
    the PNGs of the per-path request and of ``process_one``."""
    x = image(np.random.default_rng(1), 1, 16, 16, 1)
    kw = dict(ckpt_dir="/nonexistent", fused_request=True)
    out, pngs = {}, {}
    for side in ("jax", "port"):
        cap = io.StringIO()
        old = (jlogging.get_logger("engine").stream, tlogging.get_logger("engine").stream)
        jlogging.get_logger("engine").stream = tlogging.get_logger("engine").stream = cap
        try:
            if side == "jax":
                eng = JEngine(JEngineConfig(**{**_small(jcfg), "warmup": True}, **kw, persistent_cache=False))
            else:
                eng = InferenceEngine(EngineConfig(**{**_small(tcfg), "warmup": True}, **kw, device="cpu"))
            marks = [len(cap.getvalue())]
            fused = eng.fused
            for patch in PARTS[1:]:
                if patch == "fused_failing":
                    eng.fused = _boom
                elif patch == "per_path":
                    eng.fused = None
                elif patch == "path_failing":
                    (eng.fns if side == "jax" else eng._paths)["expert"] = _boom
                if patch == "one":
                    pngs[side, patch] = {n: eng.process_one(n, x, (16, 16)) for n in MODEL_NAMES}
                else:
                    results = pngs[side, patch] = eng.process_all(x, (16, 16))
                    assert (results["expert"] is None) == (patch == "path_failing"), (side, patch)
                marks.append(len(cap.getvalue()))
            eng.fused = fused
        finally:
            jlogging.get_logger("engine").stream, tlogging.get_logger("engine").stream = old
            if side == "port":
                eng.close()
        text = cap.getvalue()
        out[side] = [_events(text[a:b]) for a, b in zip([0, *marks], marks)]
    return {**out, "pngs": pngs}


PARTS = ["build", "fused", "fused_failing", "per_path", "one", "path_failing"]


@pytest.mark.parametrize("part", PARTS)
def test_engine_log_events_match_the_jax_engine(logs, part):
    i = PARTS.index(part)
    jax_events, port_events = logs["jax"][i], logs["port"][i]
    assert port_events == jax_events
    names = [e[1] for e in port_events]
    want = {"build": ["warmup_compile"] * 5,
            "fused": ["encode"] * 4 + ["request_all"],
            "fused_failing": ["fused_dispatch_failed"] + ["encode"] * 4 + ["request_all"],
            "per_path": ["encode"] * 4 + ["request_all"],
            "one": ["request"] * 4,
            "path_failing": ["model_failed"] + ["encode"] * 3 + ["request_all"]}[part]
    assert names == want
    if part == "one":
        assert [e[2] for e in port_events] == [{"model": n} for n in MODEL_NAMES]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_process_one_answers_process_alls_png(logs, side):
    one, every = logs["pngs"][side, "one"], logs["pngs"][side, "per_path"]
    for name in MODEL_NAMES:
        assert one[name] is not None and one[name] == every[name], name
