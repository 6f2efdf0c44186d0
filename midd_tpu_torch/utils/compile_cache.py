"""Persistent compiler cache and pinned serving programs (counterpart of
``midd_tpu/utils/compile_cache.py``, with the same names).

The port runs eagerly, and its kernels' libraries are already kept on disk
(``ops/_build.py``: ``midd_tpu_torch/build/``, keyed by a hash of source,
headers and flags). What a process start can skip is what the JAX package
pins: each serving program, compiled whole. Here that program is an
AOTInductor package:

1. ``enable_persistent_cache()`` points Inductor's cache (and Triton's,
   under it) at a directory on disk, so that a program compiled again
   reuses the kernels compiled for the last one.

2. ``save_executable`` / ``load_executable``: ``torch.export`` of a module,
   compiled ahead of time by AOTInductor into one ``.pt2`` file, and loaded
   back in another process. The port's hand-written kernels stay in the
   program as the custom ops ``midd::flash_fwd`` and ``midd::ln2d``
   (``ops/flash_attention.py``, ``ops/ln2d.py``): the program calls their
   wrappers at run time, which launch the kernels and count the launches.
   Inductor compiles what XLA compiled for the JAX package around them
   (convolutions, norms, elementwise chains).

3. ``pin_or_load`` (one program, in this process) and ``pin_all`` (a
   start's programs, each missing one built, exported and compiled in a
   worker process of its own, as many at once as ``pin_workers`` allows,
   the others queued; each worker reports its export and compile seconds)
   load a pin or compile it; ``AotDispatch`` serves the pinned batch sizes,
   counts what each served, and sends the others to the eager path;
   ``aot_fingerprint`` keys a pin.

A program takes the weights as inputs (the serving engine's pins take
``(flats, x)``, its weights packed into one buffer per dtype), never as
constants, so that one pin serves any checkpoint of the same architecture,
as the JAX package passes its weights as jit arguments.
"""

from __future__ import annotations

import functools
import gc
import hashlib
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from midd_tpu_torch.utils.logging import get_logger

log = get_logger("compile_cache")
# the directory that holds the package, for the compile workers' sys.path
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# repo-local by default (git-ignored); override with MIDD_TPU_TORCH_CACHE_DIR
DEFAULT_CACHE_DIR = os.environ.get(
    "MIDD_TPU_TORCH_CACHE_DIR",
    os.path.join(_PACKAGE_ROOT, ".torch_cache"),
)


# A start compiles its pins for minutes of the host's cores at 512²: the
# host code that launches a program's kernels (thousands of launches a
# rollout) is compiled unoptimised, and a pointwise kernel takes Inductor's
# heuristic block size rather than timing each candidate on the card. Every
# kernel that reads a weight reads the one packed buffer, and Inductor's
# search for fusions tries each kernel against the next ones that read a
# buffer it reads: 16 of them rather than 64 (at 64 the search took 51 of
# the 304 s of compile of the int8 diffusion rollout at 256² on the CPU,
# at 16 it took 14). The int8 product keeps eager's ``torch._int_mm``
# (cuBLASLt): Inductor's lowering of it (``tuned_int_mm``) offers its Triton
# matmul template beside it even with max-autotune off, and with two
# choices times both at every int8 shape of a program while compiling and
# may bake the template in; with the ATen backend alone it has one choice
# and times nothing. A CPU pin serves the tests
# (the port serves on the card): its kernels are plain C++ loops, without
# Inductor's vectorisation analysis.
INDUCTOR_CONFIGS = {"aot_inductor.compile_wrapper_opt_level": "O0", "max_fusion_buffer_group_pairwise_attempts": 16}
CUDA_INDUCTOR_CONFIGS = {"triton.autotune_pointwise": False, "max_autotune_gemm_backends": "ATEN"}
CPU_INDUCTOR_CONFIGS = {"cpp.vec_isa_ok": False}

# A compile worker runs Python for most of its time (export, lowering,
# scheduling: one core) beside Inductor's own pool of kernel compilers, and
# builds an engine on the device: ``pin_all`` runs one worker for this many
# of the host's cores and queues the rest.
CORES_PER_PIN_WORKER = 2


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Point Inductor's on-disk cache (``TORCHINDUCTOR_CACHE_DIR``) and
    Triton's (``TRITON_CACHE_DIR``, ``<dir>/triton``) at ``cache_dir``, or
    at ``DEFAULT_CACHE_DIR``. Idempotent; returns the directory in effect. A
    directory the process already set (by the environment, or by Inductor
    itself after a first compile) is kept unless ``cache_dir`` is passed:
    enabling the cache as a constructor's side effect must not clobber the
    embedding application's setting. The directory is made at the first
    write, by Inductor."""
    current = os.environ.get("TORCHINDUCTOR_CACHE_DIR")
    if cache_dir is None and current:
        return current
    d = os.path.abspath(cache_dir or DEFAULT_CACHE_DIR)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = d
    os.environ["TRITON_CACHE_DIR"] = os.path.join(d, "triton")
    return d


@functools.cache
def aot_cxx() -> str:
    """The C++ compiler AOTInductor builds a package with: Inductor's own
    choice, ``$CXX`` (else ``g++``), where it can link OpenMP, which the AOT
    build links on Linux (``-fopenmp``); else ``g++`` or ``c++`` from PATH
    (a minimal toolchain named by ``$CXX`` may lack ``libgomp``). Raises
    where none can."""
    probe = "#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n"
    tried = [c for c in dict.fromkeys([os.environ.get("CXX", "g++"), shutil.which("g++"), shutil.which("c++")])
             if c]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cc")
        with open(src, "w") as f:
            f.write(probe)
        for cxx in tried:
            cmd = [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "omp")]
            if shutil.which(cxx) and subprocess.run(cmd, capture_output=True).returncode == 0:
                return cxx
    raise RuntimeError(f"no C++ compiler here links OpenMP (-fopenmp), which AOTInductor's build needs; "
                       f"tried {tried}")


def save_executable(exported_program, path: str) -> None:
    """Compile an ``ExportedProgram`` with AOTInductor into the package
    ``path`` (a ``.pt2`` file), replacing it atomically: a reader never sees
    a half-written pin."""
    from torch._inductor import aoti_compile_and_package

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.pt2"
    on_cpu = all(t.device.type == "cpu" for t in torch.utils._pytree.tree_leaves(exported_program.example_inputs)
                 if isinstance(t, torch.Tensor))
    configs = {"cpp.cxx": (None, aot_cxx()), **INDUCTOR_CONFIGS,
               **(CPU_INDUCTOR_CONFIGS if on_cpu else CUDA_INDUCTOR_CONFIGS)}
    try:
        aoti_compile_and_package(exported_program, package_path=tmp, inductor_configs=configs)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_executable(path: str, device: Optional[torch.device] = None):
    """Load a package written by ``save_executable``: a callable that takes
    the exported module's inputs, on ``device`` (a CUDA package: the card of
    that index, default the current one)."""
    from torch._inductor import aoti_load_package

    index = -1 if device is None or device.index is None else device.index
    return aoti_load_package(path, device_index=index)


def aot_fingerprint(**ident) -> str:
    """Stable hex key of one pinned program: the caller's identity (model,
    shapes, steps, eps, dtypes, configs, the state's structure) plus the
    torch and CUDA versions, the device's name and the device count. Any
    change recompiles rather than loading a stale program. ``device`` (in
    ``ident``) names the device the program runs on; the CPU's name is its
    architecture and vector ISA, which Inductor compiles for."""
    device = torch.device(ident.get("device", "cuda"))
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
    else:
        name = f"{platform.machine()}:{torch.backends.cpu.get_cpu_capability()}"
    full = dict(ident, torch_version=torch.__version__, cuda_version=torch.version.cuda,
                device_name=name, n_devices=torch.cuda.device_count())
    blob = json.dumps(full, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def _materialise(out) -> None:
    """Wait for a program's outputs (a tensor or a nest of them)."""
    for t in torch.utils._pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


def export(module: torch.nn.Module, example_args: Sequence):
    """``torch.export`` of ``module`` at ``example_args``' shapes, under
    ``no_grad`` (not ``inference_mode``, whose tensors export cannot
    trace)."""
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args), strict=False)


def _load_pin(path: str, example_args: Sequence, device: Optional[torch.device]):
    """The pin at ``path``, loaded and run once on ``example_args``; None
    where there is none, or where it fails to load or to run (logged as
    ``aot_pin_broken``: it is recompiled over)."""
    if not os.path.exists(path):
        return None
    try:
        program = load_executable(path, device)
        with torch.no_grad():
            _materialise(program(*example_args))
        return program
    except Exception as e:  # noqa: BLE001 - a stale or broken pin: recompile it
        log.log("aot_pin_broken", path=path, error=f"{type(e).__name__}: {e}")
        return None


def pin_workers(n_pins: int, cores: Optional[int] = None) -> int:
    """Compile workers to run at once for ``n_pins`` missing pins: one for
    each ``CORES_PER_PIN_WORKER`` of ``cores`` (default: the cores this
    process may run on), at least one, at most ``n_pins``."""
    cores = len(os.sched_getaffinity(0)) if cores is None else cores
    return max(1, min(n_pins, cores // CORES_PER_PIN_WORKER))


def _compile_phases() -> Dict[str, float]:
    """Seconds of each of Inductor's timers (nested: tracing, lowering,
    scheduling, kernel codegen, the wait for the kernel compilers, the C++
    build) that took a second or more in this process."""
    from torch._dynamo import utils

    metrics = getattr(utils, "compilation_time_metrics", {})
    return {k: round(sum(v), 2) for k, v in metrics.items() if sum(v) >= 1.0}


def _compile_job(build_path: str, path: str, report_path: str) -> None:
    """A worker process's job (``python -m midd_tpu_torch.utils.compile_cache
    BUILD PIN REPORT``): ``build``, unpickled from BUILD (this package's
    callers wrote it), gives the module and its example inputs; they are
    exported and compiled into the pin ``path``. Writes REPORT (JSON): the
    seconds to build the module (``build_s``), to export it (``export_s``)
    and to compile it (``compile_s``), Inductor's phases of the compile, the
    kernel compilers it was given (``compile_threads``) and the worker's
    peak device memory (``peak_device_mb``)."""
    import pickle

    t = time.perf_counter()
    with open(build_path, "rb") as f:
        build = pickle.load(f)
    module, example_args = build()
    report = {"build_s": time.perf_counter() - t}
    t = time.perf_counter()
    exported = export(module, example_args)
    report["export_s"] = time.perf_counter() - t
    # what built the module (a whole engine's models) is not needed to
    # compile: its device memory goes back before the compile starts
    del build, module, example_args
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t = time.perf_counter()
    save_executable(exported, path)
    report["compile_s"] = time.perf_counter() - t
    report["phases"] = _compile_phases()
    report["compile_threads"] = os.environ.get("TORCHINDUCTOR_COMPILE_THREADS")
    report["peak_device_mb"] = (torch.cuda.max_memory_reserved() / 2**20) if torch.cuda.is_available() else 0.0
    with open(report_path, "w") as f:
        json.dump(report, f)


def pin_all(jobs: Sequence[Tuple[str, Sequence, Callable]], device: Optional[torch.device] = None) -> list:
    """Pinned programs for each (path, example_args, build) of ``jobs``:
    the pins found at ``path`` are loaded and validated on ``example_args``
    (the program's inputs); each of the others is built, exported and
    compiled in a worker process of its own (Inductor's lowering and export
    run in Python, one core a program, and neither is safe on several
    threads), ``pin_workers`` of them at once, started in ``jobs``' order
    as workers finish. ``build`` is a picklable callable
    that gives the worker (module, example_args). Returns [(program, loaded,
    info)] in ``jobs``' order: ``info`` holds a load's seconds (``load_s``)
    or a compile's worker report (``_compile_job``) with the seconds it
    queued (``queued_s``) and ran (``worker_s``). A compile or load that
    fails raises, and stops the workers still running."""
    import pickle

    results = [None] * len(jobs)
    todo = []
    for i, (path, example_args, _) in enumerate(jobs):
        t = time.perf_counter()
        program = _load_pin(path, example_args, device)
        if program is None:
            todo.append(i)
        else:
            results[i] = (program, True, {"load_s": time.perf_counter() - t})
    if not todo:
        return results
    workers = pin_workers(len(todo))
    # the workers that run at once share the cores: Inductor's own pool of
    # kernel compilers in each is cut to its part of them
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_PACKAGE_ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]),
        TORCHINDUCTOR_COMPILE_THREADS=str(max(1, len(os.sched_getaffinity(0)) // workers)))
    infos: Dict[int, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        queue, running, failed = list(todo), {}, None
        t0 = time.perf_counter()
        try:
            while (queue and failed is None) or running:
                while queue and failed is None and len(running) < workers:
                    i = queue.pop(0)
                    path, _, build = jobs[i]
                    stem = os.path.join(tmp, str(i))
                    with open(f"{stem}.pkl", "wb") as f:
                        pickle.dump(build, f)
                    with open(f"{stem}.err", "w") as err:
                        proc = subprocess.Popen([sys.executable, "-m", __name__, f"{stem}.pkl", path,
                                                 f"{stem}.json"], env=env, stdout=subprocess.DEVNULL,
                                                stderr=err)
                    running[i] = (proc, time.perf_counter())
                    infos[i] = {"queued_s": running[i][1] - t0}
                for i, (proc, started) in list(running.items()):
                    if proc.poll() is None:
                        continue
                    del running[i]
                    infos[i]["worker_s"] = time.perf_counter() - started
                    if proc.returncode:
                        with open(os.path.join(tmp, f"{i}.err")) as f:
                            failed = failed or (i, proc.returncode, f.read())
                        continue
                    with open(os.path.join(tmp, f"{i}.json")) as f:
                        infos[i].update(json.load(f))
                if failed is not None:
                    for proc, _ in running.values():
                        proc.kill()
                time.sleep(0.2)
        finally:
            for proc, _ in running.values():
                proc.kill()
                proc.wait()
    if failed is not None:
        i, code, err = failed
        raise RuntimeError(f"compiling the pin {jobs[i][0]} failed ({code}):\n{err[-4000:]}")
    for i in todo:
        results[i] = (load_executable(jobs[i][0], device), False, infos[i])
    return results


def pin_or_load(module: torch.nn.Module, example_args: Sequence, path: str,
                device: Optional[torch.device] = None):
    """A compiled program of ``module`` at ``example_args``' shapes, in this
    process: loaded from ``path`` when a pin is there and runs on the
    example inputs, else exported, compiled and written to ``path``. Returns
    (program, loaded). A pin that fails to load or to run is logged
    (``aot_pin_broken``) and recompiled over; a compile or load that fails
    after that raises."""
    program = _load_pin(path, example_args, device)
    if program is not None:
        return program, True
    save_executable(export(module, example_args), path)
    return load_executable(path, device), False


def _dense_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


class AotDispatch:
    """Serve pinned programs by leading batch size, and every other input
    through ``fallback``, the eager path (which runs the same kernels).

    ``execs``: {batch: program}; ``bound_args``: the leading inputs bound at
    dispatch (the weights, which ride as program inputs); ``like``: an
    example input, whose shape past the batch, dtype and device a pinned
    input must have (a program does not check its inputs: it would read
    another shape wrongly). The programs were compiled for dense inputs, so
    an input with other strides (a size-1 channel may carry any stride, and
    an external convolution reads such a tensor as channels-last) is copied
    densely first. A program that raises is dropped for good, counted in
    ``dropped`` and logged (``aot_dispatch_failed``), and its batch size
    goes to the fallback. ``served`` counts the calls each pinned program
    answered, by batch size."""

    def __init__(self, fallback: Callable, execs: Dict[int, Callable], bound_args: Tuple = (),
                 like: Optional[torch.Tensor] = None):
        self._fallback = fallback
        self._execs = dict(execs)
        self._bound = tuple(bound_args)
        self._like = None if like is None else (tuple(like.shape[1:]), like.dtype, like.device)
        self.dropped = 0
        self.served: Dict[int, int] = {b: 0 for b in self._execs}
        self._lock = threading.Lock()

    @property
    def pinned(self) -> Tuple[int, ...]:
        """The batch sizes served by a pinned program."""
        return tuple(sorted(self._execs))

    def __call__(self, x: torch.Tensor):
        b = int(x.shape[0])
        program = self._execs.get(b)
        if program is None or (self._like is not None and (tuple(x.shape[1:]), x.dtype, x.device) != self._like):
            return self._fallback(x)
        if x.stride() != _dense_strides(x.shape):
            x = x.clone(memory_format=torch.contiguous_format)
        try:
            out = program(*self._bound, x)
        except Exception as e:  # noqa: BLE001 - a broken pin: drop it, serve eagerly
            with self._lock:
                if self._execs.pop(b, None) is not None:
                    self.dropped += 1
            log.log("aot_dispatch_failed", batch=b, error=f"{type(e).__name__}: {e}")
            return self._fallback(x)
        with self._lock:
            self.served[b] += 1
        return out


if __name__ == "__main__":
    _compile_job(*sys.argv[1:4])
