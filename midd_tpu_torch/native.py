"""ctypes bridge to the port's native C++ data-path kernels (counterpart of
``midd_tpu/native.py``), built from the port's own copy of the source,
``midd_tpu_torch/csrc/midd_native.cc``.

The library is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``midd_tpu_torch/build/`` (git-ignored), named by a hash of the source and
the flags as ``ops/_build.py`` names the kernel libraries, so an edited
source builds anew; nothing is built at import. The wrappers take and
return numpy arrays; the image resize and the paired augmentation run in
C++ with the GIL released (ctypes drops it for the call), so the loader's
threads resize in parallel.

``load()`` returns None where the library cannot be built or loaded, as the
JAX bridge's does, and ``error()`` says why. Unlike the JAX package, the
port's callers do not fall back to PIL when they asked for this path:
``train.data.load_image(use_native=True)`` raises, and so do the wrappers
here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "midd_native.cc"
BUILD_DIR = SOURCE.parent.parent / "build"
CXX = "g++"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmidd_native_{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable
    (``error()`` gives the reason). The first call decides for the process."""
    global _lib, _error, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        u8 = ctypes.POINTER(ctypes.c_uint8)
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.resize_bicubic_u8.argtypes = [u8, ctypes.c_int, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int]
        lib.resize_bicubic_f32.argtypes = [f32, ctypes.c_int, ctypes.c_int, f32, ctypes.c_int, ctypes.c_int]
        lib.augment_pair_f32.argtypes = [
            f32, f32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def error() -> Optional[str]:
    """Why ``load()`` returned None (None if it has not failed)."""
    return _error


def require() -> ctypes.CDLL:
    """The loaded library, or a ``RuntimeError`` saying why there is none."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native data-path library ({SOURCE.name}) is unavailable: {_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_bicubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) uint8 -> (oh, ow) uint8, PIL-BICUBIC-compatible."""
    lib = require()
    img = np.ascontiguousarray(img, np.uint8)
    oh, ow = size
    out = np.empty((oh, ow), np.uint8)
    lib.resize_bicubic_u8(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                          _ptr(out, ctypes.c_uint8), oh, ow)
    return out


def resize_bicubic_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) float32 -> (oh, ow) float32, the same filter unrounded."""
    lib = require()
    img = np.ascontiguousarray(img, np.float32)
    oh, ow = size
    out = np.empty((oh, ow), np.float32)
    lib.resize_bicubic_f32(_ptr(img, ctypes.c_float), img.shape[0], img.shape[1],
                           _ptr(out, ctypes.c_float), oh, ow)
    return out


def augment_pair_f32(
    clean: np.ndarray,
    noisy: np.ndarray,
    hflip: bool = False,
    vflip: bool = False,
    brightness: float = 1.0,
    contrast: float = 1.0,
    noise_std: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paired augmentation on (H, W) fp32 arrays (on copies of the inputs)."""
    lib = require()
    c = np.ascontiguousarray(clean, np.float32).copy()
    n = np.ascontiguousarray(noisy, np.float32).copy()
    flags = (1 if hflip else 0) | (2 if vflip else 0)
    lib.augment_pair_f32(_ptr(c, ctypes.c_float), _ptr(n, ctypes.c_float), c.shape[0], c.shape[1], flags,
                         ctypes.c_float(brightness), ctypes.c_float(contrast), ctypes.c_float(noise_std),
                         ctypes.c_uint64(seed))
    return c, n
