"""Timing and tracing of the port (counterpart of ``midd_tpu/utils/profiling.py``).

- ``Timer``: accumulating named wall-clock sections with one structured
  JSON line per ``emit``. A section on a CUDA device synchronises that device
  before it starts and before it stops, so the queued work is inside it.
- ``device_trace(log_dir)``: a ``torch.profiler`` trace of the block (CUDA
  activity too when a card is present), written as a Chrome trace into
  ``log_dir``; a no-op when ``log_dir`` is None.
- ``annotate(name)``: a decorator that puts a function's calls in a named
  ``torch.profiler.record_function`` range.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time
from typing import Dict, Optional, Union

import torch


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Accumulating named wall-clock timers with structured log emission to
    ``stream`` (None: the ``sys.stderr`` of the time of each ``emit``).
    ``device``: the device whose queued work each section waits for (None or
    a CPU device: no wait)."""

    def __init__(self, name: str = "timer", stream=None,
                 device: Union[str, torch.device, None] = None):
        self.name = name
        self.stream = stream
        self.device = torch.device(device) if device is not None else None
        self.records: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, label: str):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            dt = time.perf_counter() - t0
            self.records[label] = self.records.get(label, 0.0) + dt

    def emit(self, **extra):
        payload = {"event": self.name, **{k: round(v, 4) for k, v in self.records.items()}, **extra}
        print(json.dumps(payload), file=self.stream or sys.stderr, flush=True)
        self.records.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block, written to
    ``<log_dir>/trace.json`` (Chrome trace format). No-op when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A ``record_function`` range around each call of the decorated
    function (shows up by name in the trace)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
