"""ctypes binding of the native host library (counterpart of
``gsorb_slam_tpu/frontend/native.py``).

``native/gsorb_native.cpp`` holds the host-sequential pieces of the
runtime. The port binds the one it calls: the exact 3-nearest-neighbour
grid search of the splat scale initializers. The ORB quad-tree keypoint
distribution is bound with the ORB frontend that calls it, and the
timestamp association is ``slam.dataset.associate_timestamps`` in Python,
as in the JAX loaders. The port compiles that source itself at first use,
with ``g++ -O3 -fPIC -shared -std=c++17``, into ``build/native/`` at the
repository root (``build/`` is in ``.gitignore``), under a name that
carries a hash of the source and flags, and never loads or writes ``native/libgsorb_native.so``
(the JAX package's build, which it rebuilds in place when stale). Each
build writes a temporary file and renames it, so processes that build at
once do not see each other's partial output. There is no fallback: a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gsorb_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_FP = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {"exact_knn3": [_FP, _U8P, ctypes.c_int, _FP]}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgsorb_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this source exists; returns
    its path. Raises with the compiler's output when ``g++`` fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native library cannot be built") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def exact_knn3_native(pts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Exact 3-NN mean squared distance among the valid points ``[N, 3]``
    (the simple_knn / distCUDA2 contract, ``src/simple_knn.cu:45-221``) by
    the native grid search; invalid rows get 0."""
    pts = np.ascontiguousarray(pts, np.float32)
    v = np.ascontiguousarray(valid, np.uint8)
    if pts.ndim != 2 or pts.shape[1] != 3 or v.shape != (len(pts),):
        raise ValueError(f"exact_knn3 wants pts [N, 3] and valid [N], got {pts.shape}, {v.shape}")
    out = np.zeros(len(pts), np.float32)
    library().exact_knn3(_ptr(pts, ctypes.c_float), _ptr(v, ctypes.c_uint8), len(pts),
                         _ptr(out, ctypes.c_float))
    return out
