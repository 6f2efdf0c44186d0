"""The load generator: a process of its own, so that its Python never takes
the server's interpreter lock. It imports the standard library, numpy and
``perfbench.inputs`` only.

It speaks with ``run.py`` over its standard input and output, one JSON
object a line:

1. in: the job (seed, served size, uploads, traffic kind and parameters,
   window seconds, answers to keep); it makes the uploads' multipart bodies
   and answers ``{"ready": ...}``;
2. in: ``{"port": p}``; it sends the traffic kind's warm-up requests to
   ``127.0.0.1:p`` and answers ``{"warm": ...}``;
3. in: ``{"t_start": t}`` (``time.monotonic``, which the two processes
   share); it runs ``<root>/perfbench/traffic/<kind>.py`` (the job's
   checkout) over [t, t + seconds), waits up to a minute past the close for
   answers still due, and prints the records, the top-level names of the
   modules it has loaded (the harness refuses a run whose generator loaded
   JAX), then the kept answers' bodies, one a line.

Run: ``python3 perfbench/loadgen.py`` (``run.py`` starts it).
"""

from __future__ import annotations

import http.client
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import inputs  # noqa: E402

PATHS = ("diffusion", "nafnet", "expert", "hybrid")
GRACE_S = 60.0


class Client:
    """POST /denoise of upload ``index``; each call records what it saw."""

    def __init__(self, port: int, bodies):
        self.port, self.bodies = port, bodies
        self.records, self.answers = [], {}
        self._lock = threading.Lock()

    def post(self, index: int, due=None, keep=True) -> dict:
        """The request's record: upload, due and send times, and once it is
        answered its time, status and whether all four paths answered. A
        kept record is listed from its send on, so one never answered shows."""
        body, ctype = self.bodies[index]
        rec = {"upload": index, "due": due, "send": time.monotonic(), "done": None, "status": None,
               "ok": False, "error": None, "id": None, "in_window": False}
        if keep:
            with self._lock:
                rec["id"] = len(self.records)
                self.records.append(rec)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=GRACE_S + 30)
            try:
                conn.request("POST", "/denoise", body, {"Content-Type": ctype, "Connection": "close"})
                resp = conn.getresponse()
                answer = resp.read()
            finally:
                conn.close()
            done = time.monotonic()
            if resp.status == 200:
                out = json.loads(answer)
                if all(isinstance(out.get(p), str) and out[p] for p in PATHS):
                    if keep:
                        self.answers[rec["id"]] = answer
                    rec["ok"] = True
                else:
                    rec["error"] = "a path answered null"
            else:
                rec["error"] = answer[:300].decode(errors="replace")
            rec["status"], rec["done"] = resp.status, done
        except (OSError, http.client.HTTPException, ValueError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        return rec


def sample(records, n: int, seed: int, plan) -> list:
    """Ids of ``n`` answered requests of the window drawn from the seed,
    the one with the largest upload among them."""
    ok = [r for r in records if r["ok"] and r.get("in_window")]
    if not ok or n <= 0:
        return []
    largest = max(ok, key=lambda r: plan[r["upload"]][0] * plan[r["upload"]][1])
    rest = [r["id"] for r in ok if r is not largest]
    picks = np.random.default_rng([seed % 2**64, 3]).permutation(len(rest))[:max(0, n - 1)]
    return [largest["id"]] + [rest[i] for i in sorted(picks)]


def traffic_kind(root: Path, kind: str):
    """``<root>/perfbench/traffic/<kind>.py``, found by name."""
    path = root / "perfbench" / "traffic" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_traffic_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    job = json.loads(sys.stdin.readline())
    seed, n = job["seed"], job["uploads"]
    plan = inputs.plan(seed, n, job["img_size"])
    t = time.monotonic()
    bodies = [inputs.multipart(inputs.upload(seed, i, job["img_size"], n)) for i in range(n)]
    print(json.dumps({"ready": round(time.monotonic() - t, 3)}), flush=True)

    client = Client(json.loads(sys.stdin.readline())["port"], bodies)
    traffic = traffic_kind(Path(job["root"]), job["kind"])
    t = time.monotonic()
    traffic.warm(client, n, job["params"])
    print(json.dumps({"warm": round(time.monotonic() - t, 3)}), flush=True)

    t_start = json.loads(sys.stdin.readline())["t_start"]
    t_end = t_start + job["seconds"]
    extra = traffic.run(client, n, job["params"], seed, t_start, t_end, t_end + GRACE_S) or {}
    for r in client.records:
        r["in_window"] = t_start <= (r["due"] if r["due"] is not None else r["send"]) < t_end
    kept = sample(client.records, job["check"], seed, plan)
    modules = sorted({m.split(".")[0] for m in sys.modules})
    print(json.dumps({"records": client.records, "kept": kept, "traffic": extra, "modules": modules}), flush=True)
    for i in kept:
        sys.stdout.write(client.answers[i].decode() + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
