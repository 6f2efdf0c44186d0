"""One run of one cell: the port's server under the cell's traffic for the
window, then the metrics and the check of its answers.

Everything a cell, a configuration, a traffic kind or a metric adds is a
file the harness finds by name:

- ``BENCHMARK.json``: the cell's entry and the metrics it reports;
- ``perfbench/workloads/<cell>.json``: traffic kind, its parameters, the
  uploads, the answers checked and their limits;
- ``perfbench/configs/<config>.json``: the server's arguments and the
  models' sizes (the reference's, and the checkpoints' metadata);
- ``perfbench/traffic/<kind>.py``: the load generator's loop;
- ``perfbench/metrics/<metric>.py``: ``read(run) -> float | None``.

The harness itself, the readers and the reference may load no module of
JAX or of the JAX package (``FORBIDDEN``, compared by top-level name), nor
may the load generator's process: ``check_modules`` refuses the run.

The system under test is ``midd_tpu_torch``'s HTTP server
(``serve/server.py``: ``config_from_args``, ``make_server``) around its
``InferenceEngine``, started as its command line would start it. With
tracing on, the harness also wraps (never edits) the engine's
``process_all`` and path functions and the two kernel wrappers, to time
spans and read the calls' shapes, and runs ``torch.profiler`` over the
window; the end-to-end metrics come from runs with tracing off.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "midd_tpu")
PATHS = ("diffusion", "nafnet", "expert", "hybrid")


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""


@dataclass
class Cell:
    name: str
    root: Path
    entry: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    workload = json.loads((root / "perfbench" / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
    config = json.loads((root / "perfbench" / "configs" / f"{entry['config']}.json").read_text())

    def mine(m, reported=None):
        if "workloads" in m:
            return name in m["workloads"]
        return reported is None or m["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m, {m["name"] for m in e2e})]
    return Cell(name, root, entry, workload, config, e2e, layer)


def reader(root: Path, metric: str):
    """``perfbench/metrics/<metric>.py``'s ``read``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Run:
    """What the readers read: the window, its requests, and (traced) the
    device's kernels, the harness's spans and the kernel calls' shapes."""

    seconds: float
    t_start: float
    t_end: float
    setup_s: float
    records: List[Dict] = field(default_factory=list)  # the window's requests
    flops: Dict[str, float] = field(default_factory=dict)
    batcher: Optional[Dict[str, Any]] = None
    path_ms: Dict[str, List[float]] = field(default_factory=dict)
    spans: Dict[str, List] = field(default_factory=dict)
    calls: Dict[str, List] = field(default_factory=dict)
    trace: Optional[Dict[str, Any]] = None

    def latency_ms(self) -> List[float]:
        """Every window request's latency, from its due time (open loop) or
        its send; a request that failed or never came is infinite."""
        return [(r["done"] - (r["due"] if r["due"] is not None else r["send"])) * 1e3 if r["ok"] else float("inf")
                for r in self.records]

    def done_in(self, t0: float, t1: float) -> int:
        return sum(1 for r in self.records if r["ok"] and t0 <= r["done"] <= t1)

    def idle_pct(self) -> Optional[float]:
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """Share of its roofline of the kernel whose trace names contain
        ``kernel``: the window's calls' mean bound (their shapes, read at the
        launcher) times the kernels the trace holds, over their device time."""
        from perfbench import yardstick

        if self.trace is None:
            return None
        n, s = 0, 0.0
        for name, (count, secs) in self.trace["kernels"].items():
            if kernel in name:
                n, s = n + count, s + secs
        calls = [c for t, c in self.calls.get(kernel, []) if self.t_start <= t < self.t_end]
        return yardstick.roofline_pct(calls, n, s)


class Probe:
    """The harness's spans around the engine's ``process_all`` and path
    functions, and the shapes of the two kernel wrappers' calls, recorded
    by wrapping them (traced runs only)."""

    def __init__(self):
        self.spans: Dict[str, List] = {"process_all": [], "path": []}
        self.calls: Dict[str, List] = {"flash_fwd": [], "ln2d": []}

    def wrap_kernels(self) -> None:
        from midd_tpu_torch.ops import flash_attention as fa
        from midd_tpu_torch.ops import ln2d as ln
        from perfbench import yardstick as ys

        def shaped(module, attr, key, cost):
            orig = getattr(module, attr)

            def wrapper(*args, **kwargs):
                x = args[0]
                self.calls[key].append((time.monotonic(), cost(*x.shape, str(x.dtype).replace("torch.", ""))))
                return orig(*args, **kwargs)

            wrapper.launches = orig.launches  # the wrapper counts its launches on itself
            setattr(module, attr, wrapper)

        shaped(fa, "flash_attention", "flash_fwd", ys.flash_fwd_cost)
        shaped(ln, "ln2d", "ln2d", ys.ln2d_cost)

    def wrap_engine(self, engine) -> None:
        orig_all = engine.process_all

        def process_all(x, size):
            t = time.monotonic()
            try:
                return orig_all(x, size)
            finally:
                self.spans["process_all"].append((t, time.monotonic()))

        engine.process_all = process_all
        for name, fn in list(engine._paths.items()):
            def path(x, _fn=fn, _name=name):
                t = time.monotonic()
                try:
                    return _fn(x)
                finally:
                    self.spans["path"].append((_name, int(x.shape[0]), t, time.monotonic()))

            engine._paths[name] = path


class HybridState:
    """The hybrid path's own rollout output, as the program computed it,
    with the input it was computed from: the state the check follows the
    hybrid's router and fusion from (``checks.py``). The harness wraps the
    engine module's ``hybrid_forward`` (never edits it) and keeps a copy of
    each call's input and rollout once ``start`` is called; a copy, so that
    a program that reuses its buffers leaves the kept state as it was."""

    def __init__(self):
        self.calls: List = []  # (time, input batch, rollout output), on the device
        self._on = False
        self._engine = self._orig = None

    def install(self) -> None:
        from midd_tpu_torch.serve import engine as eng

        self._engine, self._orig = eng, eng.hybrid_forward
        orig = self._orig

        def hybrid_forward(nafnet_apply, denoise_fn, router_apply, fusion_apply, noisy, *args, **kwargs):
            if not self._on:
                return orig(nafnet_apply, denoise_fn, router_apply, fusion_apply, noisy, *args, **kwargs)
            t = time.monotonic()

            def rollout(a):
                hq = denoise_fn(a)
                self.calls.append((t, noisy.detach().clone(), hq.detach().clone()))
                return hq

            return orig(nafnet_apply, rollout, router_apply, fusion_apply, noisy, *args, **kwargs)

        eng.hybrid_forward = hybrid_forward

    def start(self) -> None:
        self.calls.clear()
        self._on = True

    def stop(self) -> None:
        self._on = False

    def uninstall(self) -> None:
        if self._engine is not None:
            self._engine.hybrid_forward = self._orig
            self._engine = None


def _reset(engine) -> Optional[Dict[str, int]]:
    """Empty the engine's per-path walls and the batcher's waits, which the
    window then fills (nothing in the program reads them); the batcher's
    counts as they stand."""
    for ms in engine.path_ms.values():
        ms.clear()
    if engine.batcher is None:
        return None
    engine.batcher.wait_ms.clear()
    return engine.batcher.stats


class LoadGen:
    """The load generator's process (``perfbench/loadgen.py``)."""

    def __init__(self, root: Path, job: Dict[str, Any]):
        self.proc = subprocess.Popen([sys.executable, str(root / "perfbench" / "loadgen.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)
        self.say({**job, "root": str(root)})

    def say(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def hear(self) -> Dict[str, Any]:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator ended (exit {self.proc.wait()})")
        return json.loads(line)

    def answers(self, n: int) -> List[bytes]:
        return [self.proc.stdout.readline().rstrip("\n").encode() for _ in range(n)]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        for f in (self.proc.stdin, self.proc.stdout):
            f.close()


def _forbidden(names=None) -> List[str]:
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def check_modules(loadgen_modules=()) -> None:
    """Refuse the run if this process, or the load generator's (its
    top-level module names as it reported them), holds a module of JAX or
    of the JAX package."""
    here, there = _forbidden(), _forbidden(loadgen_modules)
    if here or there:
        raise ForbiddenModules("modules loaded that the benchmark may not load: "
                               f"{here} in the server's process, {there} in the load generator's")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
             extra_server_args=(), fault=None) -> Dict[str, Any]:
    """One run: the result's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, ``checks``).
    ``extra_server_args`` and ``fault`` are for the control and the fault
    tests (``perfbench/readings.py``, ``perfbench/tests``): ``fault(engine)``
    breaks the built engine in place (``perfbench/faults.py``) and may
    return a function that undoes it."""
    import torch

    from perfbench import checks, weights, yardstick

    wl, cfg = cell.workload, cell.config
    gen = LoadGen(cell.root, {"seed": seed, "img_size": cfg["img_size"], "uploads": wl["uploads"], "kind": wl["kind"],
                   "params": wl["params"], "seconds": seconds, "check": wl["check"]})
    server = engine = undo = None
    probe = Probe() if trace else None
    state = HybridState() if any(k.startswith("hybrid_") for k in wl["limits"]) else None
    ckpt = tempfile.mkdtemp(prefix="perfbench-ckpt-")
    try:
        from midd_tpu_torch.serve.engine import InferenceEngine
        from midd_tpu_torch.serve.server import config_from_args, make_server

        weights.save(cfg, weights.draw(cfg, seed, device), ckpt)
        args, ecfg = config_from_args([*cfg["server_args"], "--host", "127.0.0.1", "--port", "0",
                                       "--ckpt-dir", ckpt, "--device", device, *extra_server_args])
        if probe is not None:
            probe.wrap_kernels()
        if state is not None:
            state.install()
        engine = InferenceEngine(ecfg)
        shutil.rmtree(ckpt, ignore_errors=True)
        if any(m.get("demo_weights") for m in engine.meta.values()):
            raise RuntimeError(f"the engine did not load the benchmark's checkpoints: {engine.meta}")
        if fault is not None:
            undo = fault(engine)
        if probe is not None:
            probe.wrap_engine(engine)
        server = make_server(args.host, args.port, engine=engine)
        threading.Thread(target=server.serve_forever, name="perfbench-server", daemon=True).start()
        flops = yardstick.request_flops(cfg) if trace else {}

        gen.hear()  # the uploads are made
        gen.say({"port": server.server_address[1]})
        gen.hear()  # the warm-up requests are answered
        setup_s = time.monotonic() - t0

        prof = mark = None
        if trace:
            prof, mark = _start_profiler(torch, device)
        stats = _reset(engine)
        if state is not None:
            state.start()
        t_start = time.monotonic() + 0.05
        t_end = t_start + seconds
        gen.say({"t_start": t_start})
        time.sleep(max(0.0, t_end - time.monotonic()))
        events = _stop_profiler(torch, prof) if prof is not None else None
        path_ms = {n: list(engine.path_ms[n]) for n in PATHS}
        if stats is not None:
            now = engine.batcher.stats
            batcher = {"requests": now["requests"] - stats["requests"], "batches": now["batches"] - stats["batches"],
                       "wait_ms": list(engine.batcher.wait_ms)}
        out = gen.hear()
        kept = gen.answers(len(out["kept"]))
    finally:
        if state is not None:
            state.stop()
            state.uninstall()
        if undo is not None:
            undo()
        gen.close()
        if server is not None:
            server.shutdown()
            server.server_close()
        if engine is not None:
            engine.close()
        shutil.rmtree(ckpt, ignore_errors=True)

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del engine, server
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    records = [r for r in out["records"] if r["in_window"]]
    run = Run(seconds=seconds, t_start=t_start, t_end=t_end, setup_s=setup_s, records=records, flops=flops,
              path_ms=path_ms, batcher=batcher if stats is not None else None)
    breakdown = None
    if trace:
        run.spans, run.calls = probe.spans, probe.calls
        run.trace, breakdown = _read_trace(events, mark, t_start, t_end, probe.spans, yardstick)

    by_id = {r["id"]: r for r in out["records"]}
    compared = checks.compare(cfg, seed, wl, [by_id[i] for i in out["kept"]], kept, device,
                              n_failed=sum(not r["ok"] for r in records),
                              hybrid_state=state.calls if state is not None else None)
    if state is not None:
        state.calls.clear()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    result = {"correct": compared["correct"], "attempted": len(records),
              "failed": sum(not r["ok"] for r in records), "metrics": metrics, "device": dev,
              "load": {"setup_s": setup_s, "traffic": out["traffic"], "kept": len(kept),
                       "levels": compared["detail"]}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared["checks"]
    check_modules(out["modules"])
    return result


def _start_profiler(torch, device):
    """The profiler over the device's activity, and the host time
    (``time.monotonic``) at which the trace's first device event, a marker
    kernel launched while the server is idle, started: it ties the trace's
    clock to the host's."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    mark = time.monotonic()
    torch.ones(1, device=device).add_(1)
    torch.cuda.synchronize()
    return prof, mark


def _stop_profiler(torch, prof) -> List:
    prof.stop()
    return [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _read_trace(events, mark: float, t_start: float, t_end: float, spans, yardstick):
    """Busy and window seconds, kernel seconds and counts by name within the
    window, and the breakdown: the device operations that took most time
    and the idle time by what the harness's spans say the host was doing."""
    if not events:
        return None, None
    first = min(s for _, s, _ in events)
    to_host = lambda ns: mark + (ns - first) / 1e9  # noqa: E731
    by_name: Dict[str, List[float]] = {}
    intervals = []
    for name, s, d in events:
        a, b = max(to_host(s), t_start), min(to_host(s + d), t_end)
        if b <= a:
            continue
        intervals.append((a, b))
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += b - a
    busy, gaps = yardstick.union_s(intervals)
    if intervals:
        lo, hi = min(a for a, _ in intervals), max(b for _, b in intervals)
        gaps = [(t_start, lo)] * (lo > t_start) + gaps + [(hi, t_end)] * (hi < t_end)
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        best, label = 0.0, "no path dispatching (queue, batcher wait, copies back, PNG codec)"
        for name, rows, s0, s1 in spans["path"]:
            over = min(g1, s1) - max(g0, s0)
            if over > best and over > 0.5 * (g1 - g0):
                best, label = over, f"dispatching the {name} path (batch {rows})"
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    ops = sorted(((f"{yardstick.kind(n)}: {n[:100]}", v[1]) for n, v in by_name.items()), key=lambda kv: -kv[1])[:10]
    trace = {"busy_s": busy, "window_s": t_end - t_start, "kernels": by_name}
    breakdown = {"device_ops": [[n, s] for n, s in ops],
                 "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
    return trace, breakdown


def quantile_ms(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile; None if it falls on a failed request."""
    if not values:
        return None
    v = sorted(values)[max(0, int(np.ceil(q * len(values))) - 1)]
    return None if v == float("inf") else v

