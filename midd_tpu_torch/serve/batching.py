"""Dynamic micro-batching for serving (counterpart of
``midd_tpu/serve/batching.py``).

Concurrent requests queue here and are coalesced into one batch per model
call: the batch is padded up to the nearest bucket size by repeating its last
request, every model function runs once on it, and the results are sliced
back per request. Per-request latency stays bounded by ``max_wait_ms``.

- one collector thread; each request arrives with a Future;
- per-model isolation: a model that raises gives None to every request of
  the batch;
- load-adaptive turbo: when the queue depth, measured after a batch was
  collected, reaches ``turbo_queue_depth``, the models named in
  ``turbo_fns`` run their turbo versions for that batch;
- bounded admission: ``submit`` raises ``QueueFull`` when
  ``max_queue_depth`` requests already wait (the server answers 503);
- a fused function, when given, computes every model's output in one call;
  if it raises, the batch falls back to the per-model functions, and the
  failure is logged (``fused_dispatch_failed``, the JAX engine's event) and
  counted in ``stats["fused_failures"]``. A model that raises is logged as
  ``model_failed``. (The JAX batcher logs neither: its functions' failures
  surface in its engine.)

The model functions take and return numpy arrays (B, H, W, C). This module
holds no device state: the engine's functions run their work on its one
device thread, so the collector only hands each batch over.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Deque, Dict, Optional, Sequence

import numpy as np

from midd_tpu_torch.utils.logging import get_logger

log = get_logger("batcher")

class QueueFull(RuntimeError):
    """Raised by ``submit`` when bounded admission rejects a request."""


class MicroBatcher:
    def __init__(
        self,
        fns: Dict[str, Callable[[np.ndarray], np.ndarray]],
        buckets: Sequence[int] = (1, 2, 4, 8),
        max_wait_ms: float = 4.0,
        warmup_shape: Optional[tuple] = None,
        fused_fn: Optional[Callable[[np.ndarray], Dict[str, np.ndarray]]] = None,
        turbo_fns: Optional[Dict[str, Callable[[np.ndarray], np.ndarray]]] = None,
        turbo_queue_depth: int = 3,
        max_queue_depth: Optional[int] = None,
    ):
        self.fns = fns
        self.fused_fn = fused_fn
        self.turbo_fns = turbo_fns or {}
        self.turbo_queue_depth = turbo_queue_depth
        self.max_queue_depth = max_queue_depth
        self.buckets = sorted(buckets)
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()  # admission check-and-put, and the stats
        self._stats = {
            "requests": 0, "batches": 0, "max_batch": 0,
            "turbo_batches": 0, "rejected": 0, "fused_failures": 0,
        }
        # ms each request waited in the queue before its batch ran
        self.wait_ms: Deque[float] = collections.deque(maxlen=4096)
        self._stop = False
        if warmup_shape is not None:
            # every bucket of every function, before the first request: the
            # per-model functions too in fused mode (they are its fallback)
            for b in self.buckets:
                x = np.zeros((b, *warmup_shape), np.float32)
                for fn in (*fns.values(), *self.turbo_fns.values()):
                    fn(x)
                if fused_fn is not None:
                    fused_fn(x)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="micro-batcher")
        self._thread.start()

    def submit(self, x: np.ndarray) -> Future:
        """x: (1, H, W, C). Returns a Future of {model: (1, H, W, C) array or
        None}. Raises QueueFull when bounded admission is on and the queue
        is at capacity."""
        fut: Future = Future()
        with self._lock:
            if self.max_queue_depth is not None and self._q.qsize() >= self.max_queue_depth:
                self._stats["rejected"] += 1
                raise QueueFull(f"request queue at capacity ({self.max_queue_depth})")
            self._q.put((x, fut, time.monotonic()))
        return fut

    def process(self, x: np.ndarray, timeout: float = 300.0) -> Dict[str, Optional[np.ndarray]]:
        return self.submit(x).result(timeout=timeout)

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the collector after the batch it is running; requests still
        queued fail with RuntimeError."""
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=timeout)

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _drain(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("batcher stopped"))

    def _collect(self) -> Optional[list]:
        """One request (blocking), then more until the largest bucket is full
        or ``max_wait_ms`` has passed; None when stopping."""
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.buckets[-1]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._stop = True
                break
            batch.append(nxt)
        return batch

    def _run(self, arr: np.ndarray, turbo: bool) -> Dict[str, Optional[np.ndarray]]:
        if self.fused_fn is not None and not turbo:
            try:
                return dict(self.fused_fn(arr))
            except Exception as e:  # noqa: BLE001  fall back to the per-model functions
                with self._lock:
                    self._stats["fused_failures"] += 1
                log.log("fused_dispatch_failed", error=str(e))
        fns = {**self.fns, **self.turbo_fns} if turbo else self.fns
        outs: Dict[str, Optional[np.ndarray]] = {}
        for name, fn in fns.items():
            try:
                outs[name] = fn(arr)
            except Exception as e:  # noqa: BLE001  per-model isolation
                log.log("model_failed", model=name, error=str(e))
                outs[name] = None
        return outs

    def _loop(self) -> None:
        while not self._stop:
            batch = self._collect()
            if batch is None:
                break
            n = len(batch)
            arr = np.concatenate([b[0] for b in batch], axis=0)
            bucket = self._bucket_for(n)
            if bucket > n:
                arr = np.concatenate([arr, np.repeat(arr[-1:], bucket - n, axis=0)], axis=0)
            # depth after this batch was collected: requests that will wait
            # at least one more device round
            turbo = bool(self.turbo_fns) and self._q.qsize() >= self.turbo_queue_depth
            now = time.monotonic()
            self.wait_ms.extend((now - b[2]) * 1e3 for b in batch)
            outs = self._run(arr, turbo)
            with self._lock:  # before the results: a caller that has them reads final stats
                self._stats["requests"] += n
                self._stats["batches"] += 1
                self._stats["max_batch"] = max(self._stats["max_batch"], n)
                self._stats["turbo_batches"] += int(turbo)
            for i, (_, fut, _) in enumerate(batch):
                fut.set_result({k: (None if v is None else v[i:i + 1]) for k, v in outs.items()})
        self._drain()
