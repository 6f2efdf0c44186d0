"""Closed loop: ``clients`` callers, each posting its next upload when its
answer arrives (a clinic's workstations, a PACS pushing studies). Client c
sends uploads c, c + clients, c + 2 clients, ... of the seed's set, in turn.

Parameters: ``clients``; ``warmup_rounds``, requests per client before the
window (set-up: they reach every batch size the window forms)."""

from __future__ import annotations

import threading
import time


def _loop(client, c: int, clients: int, n: int, until: float, keep: bool, rounds=None) -> None:
    k = 0
    while (rounds is None or k < rounds) and time.monotonic() < until:
        client.post((c + k * clients) % n, keep=keep)
        k += 1


def _clients(client, n: int, clients: int, until: float, keep: bool, rounds=None, join_by=None) -> None:
    threads = [threading.Thread(target=_loop, args=(client, c, clients, n, until, keep, rounds), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(None if join_by is None else max(0.0, join_by - time.monotonic()))


def warm(client, n: int, params: dict) -> None:
    _clients(client, n, params["clients"], float("inf"), keep=False, rounds=params["warmup_rounds"])


def run(client, n: int, params: dict, seed: int, t_start: float, t_end: float, t_grace: float) -> dict:
    time.sleep(max(0.0, t_start - time.monotonic()))
    _clients(client, n, params["clients"], t_end, keep=True, join_by=t_grace)
    return {}
