"""ctypes binding of the native host library (counterpart of
``gsorb_slam_tpu/frontend/native.py``).

``native/gsorb_native.cpp`` holds the host-sequential pieces of the
runtime. The port binds the exact 3-nearest-neighbour grid search of the
splat scale initializers, the ORB quad-tree keypoint distribution
(``DistributeOctTree``) and the greedy timestamp association
(:func:`associate_timestamps_native`; the loaders associate with
``slam.dataset.associate_timestamps`` in Python, as the JAX loaders do). The
port compiles that source itself at first use,
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
_F = ctypes.c_float
_SIGNATURES = {
    "exact_knn3": [_FP, _U8P, ctypes.c_int, _FP],
    "quadtree_distribute": [_FP, _FP, _FP, ctypes.c_int, _F, _F, _F, _F, ctypes.c_int, _U8P],
    "associate_timestamps": [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                             ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
                             ctypes.POINTER(ctypes.c_int32), ctypes.c_int],
}


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


def associate_timestamps_native(a: np.ndarray, b: np.ndarray,
                                max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp pairs ``(i, j)`` of the sorted stamps ``a``
    and ``b`` within ``max_dt``, each ``b`` used once (the native loop over a
    window of 5 around the moving lower bound)."""
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    out = np.zeros(2 * len(a), np.int32)
    n = library().associate_timestamps(_ptr(a, ctypes.c_double), len(a),
                                       _ptr(b, ctypes.c_double), len(b), max_dt,
                                       _ptr(out, ctypes.c_int32), len(a))
    return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


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


def quadtree_distribute(
    x: np.ndarray, y: np.ndarray, response: np.ndarray, n_keep: int,
    bounds: tuple[float, float, float, float] | None = None,
) -> np.ndarray:
    """The reference's quad-tree spatial balancing (``DistributeOctTree``)
    of keypoints ``(x, y)`` with their responses down to ``n_keep`` ->
    boolean keep mask. ``bounds`` (min_x, min_y, max_x, max_y) default to
    the points' box plus one pixel."""
    n = len(x)
    if n == 0:
        return np.zeros(0, bool)
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    r = np.ascontiguousarray(response, np.float32)
    if bounds is None:
        bounds = (float(x.min()), float(y.min()), float(x.max()) + 1, float(y.max()) + 1)
    keep = np.zeros(n, np.uint8)
    library().quadtree_distribute(_ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float),
                                  _ptr(r, ctypes.c_float), n, *bounds, int(n_keep),
                                  _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)
