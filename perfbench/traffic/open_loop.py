"""Open loop: requests at times fixed in advance, whether or not earlier ones
were answered (independent radiologists uploading at random). Arrivals are
Poisson at ``rate_per_s`` (``inputs.gaps``: every seed offers the same
requests, in its own order); request j sends upload j mod n. A request's
latency counts from its due time, so a stalled generator's late sends are
charged to the system, and the generator reports how late it ran.

Parameters: ``rate_per_s``; ``warmup_requests``, sent at once before the
window (set-up)."""

from __future__ import annotations

import itertools
import threading
import time

from perfbench import inputs


def warm(client, n: int, params: dict) -> None:
    threads = [threading.Thread(target=client.post, args=(j % n,), kwargs={"keep": False}, daemon=True)
               for j in range(params["warmup_requests"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run(client, n: int, params: dict, seed: int, t_start: float, t_end: float, t_grace: float) -> dict:
    due = [t_start + s for s in itertools.accumulate(inputs.gaps(seed, params["rate_per_s"], t_end - t_start))]
    threads, late = [], []
    for j, t in enumerate(due):
        time.sleep(max(0.0, t - time.monotonic()))
        late.append(time.monotonic() - t)
        th = threading.Thread(target=client.post, args=(j % n, t), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(max(0.0, t_grace - time.monotonic()))
    late.sort()
    return {"offered": len(due), "late_ms_p50": late[len(late) // 2] * 1e3, "late_ms_max": late[-1] * 1e3}
