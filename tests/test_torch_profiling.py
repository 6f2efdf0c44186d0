"""The port's ``utils/profiling.py`` on the CPU: ``Timer`` emits the JAX
package's line (``midd_tpu/utils/profiling.py``), and ``device_trace``
writes a trace that holds the ranges ``annotate`` names."""

import io
import json
import os

import torch

from midd_tpu.utils.profiling import Timer as JTimer
from midd_tpu_torch.utils.profiling import Timer, annotate, device_trace


def _sections(timer):
    for label in ("load", "score", "load"):
        with timer.section(label):
            pass
    timer.emit(rows=3)


def test_timer_emits_the_jax_line():
    got, want = io.StringIO(), io.StringIO()
    _sections(Timer("bench", stream=got, device="cpu"))
    _sections(JTimer("bench", stream=want))
    line, ref = json.loads(got.getvalue()), json.loads(want.getvalue())
    assert list(line) == list(ref) == ["event", "load", "score", "rows"]
    assert line["event"] == "bench" and line["rows"] == 3
    assert all(line[k] >= 0 for k in ("load", "score"))


def test_timer_clears_after_emit_and_accumulates_a_label():
    out = io.StringIO()
    timer = Timer(stream=out)
    with timer.section("a"):
        pass
    first = timer.records["a"]
    with timer.section("a"):
        pass
    assert timer.records["a"] >= first
    timer.emit()
    assert timer.records == {}
    timer.emit()
    assert [json.loads(s) for s in out.getvalue().splitlines()][-1] == {"event": "timer"}


def test_device_trace_writes_the_annotated_range(tmp_path):
    @annotate("xb_score_rows")
    def work(x):
        return (x @ x).sum()

    with device_trace(None):  # no trace, no directory
        assert work(torch.ones(4, 4)).item() == 64.0
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir):
        assert work(torch.ones(8, 8)).item() == 512.0
    trace = json.load(open(os.path.join(log_dir, "trace.json")))
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "xb_score_rows" in names
    assert work.__name__ == "work"
    assert not os.path.exists(str(tmp_path / "none"))
