"""Builds and loads the port's hand-written CUDA kernels.

Each source under ``midd_tpu_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``midd_tpu_torch/build/`` (git-ignored), and loaded through
``ctypes``. A library's name carries a hash of its source, of the ``.cuh``
headers beside it and of the flags (``tag``), so an edited source or header
builds anew. Nothing is built at import.

Every source exports ``midd_cuda_error_string(int)``; its kernel entry
points return the launch's ``cudaError_t`` (0 = success), which the wrappers
turn into an exception with ``raise_on``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_libs: Dict[Path, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def tag(source: Path) -> str:
    """The hash a library built from ``source`` is named by: the source, every
    ``.cuh`` header in its directory (by name, in order) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(source: Path, verbose: bool = False) -> Path:
    """Compile one kernel source into ``build/`` unless a library with the
    same ``tag`` is already there. Returns its path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report. Safe
    to call for several sources at once from several threads (each nvcc
    writes its own temporary file)."""
    out = BUILD_DIR / f"libmidd_{source.stem}_{tag(source)}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library(source: Path, signatures: Dict[str, Optional[List]]) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, with the ctypes
    ``argtypes`` of each entry point declared (``None`` marks the
    error-string helper); entry points return an int."""
    with _lib_lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source)))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                if argtypes is None:
                    fn.argtypes, fn.restype = [I], ctypes.c_char_p
                else:
                    fn.argtypes, fn.restype = argtypes, I
            _libs[source] = lib
        return _libs[source]


def raise_on(err: int, lib: ctypes.CDLL, kernel: str) -> None:
    """Raise if a kernel's entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.midd_cuda_error_string(err).decode()}")


_count_lock = threading.Lock()


def count_launch(wrapper, counter: str = "launches") -> None:
    """Add one to ``wrapper.launches`` (or its ``counter``), the launch count
    of its kernel; a lock makes the read-modify-write safe for wrappers
    called from several threads (the serving engine's dp replicas)."""
    with _count_lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def pixel_strides(x: torch.Tensor, name: str) -> tuple:
    """(sb, sc, sp): the element strides of batch, channel and pixel of a
    dense (B, C, H, W) tensor in NCHW or channels-last order, pixel p = h*W +
    w. Raises for any other layout."""
    _, _, h, w = x.shape
    dense = x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)
    if not dense or (h > 1 and w > 1 and x.stride(2) != w * x.stride(3)):
        raise ValueError(f"{name}: x must be contiguous in NCHW or channels-last order, "
                         f"got strides {x.stride()} for shape {tuple(x.shape)}")
    # a dimension of size 1 may carry any stride
    return x.stride(0), x.stride(1), x.stride(3) if w > 1 else x.stride(2)


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the int ctypes passes."""
    return torch.cuda.current_stream(t.device).cuda_stream
