"""Structured logging (counterpart of ``midd_tpu/utils/logging.py``).

The reference logs with bare prints (run.py:94,110-140,206). Here the same
signals are JSON lines on stderr, one object a line: ``ts`` (seconds, 3
decimals), ``component``, ``event`` and the event's fields, the same keys
as the JAX package's, so that one parser reads both engines' logs.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict


class JsonLogger:
    def __init__(self, component: str, stream=None):
        self.component = component
        self.stream = stream or sys.stderr

    def log(self, event: str, **fields: Any) -> None:
        payload: Dict[str, Any] = {
            "ts": round(time.time(), 3),
            "component": self.component,
            "event": event,
            **fields,
        }
        print(json.dumps(payload), file=self.stream, flush=True)

    def latency(self, event: str, seconds: float, **fields: Any) -> None:
        """``event`` with ``latency_ms``: ``seconds`` in ms, rounded to 2 places."""
        self.log(event, latency_ms=round(seconds * 1000.0, 2), **fields)


_loggers: Dict[str, JsonLogger] = {}


def get_logger(component: str) -> JsonLogger:
    """The one logger of ``component``."""
    if component not in _loggers:
        _loggers[component] = JsonLogger(component)
    return _loggers[component]
