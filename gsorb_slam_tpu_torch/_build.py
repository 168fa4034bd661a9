"""Builds the port's CUDA kernels and loads them through ctypes.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started together,
then linked into one shared library with a plain C interface. The library
lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a name that carries a hash of the sources and flags,
so a stale build is never loaded. There is no fallback: a missing ``nvcc``
or a failed build raises.

Every wrapper that launches a kernel adds one to its entry in
:data:`launches` at the launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = (
    "blend_backward.cu", "blend_flat.cu", "blend_forward.cu", "fused_track.cu",
    "map_attr.cu", "preprocess_instances.cu", "ssim.cu",
)
HEADERS = ("common.cuh", "ewa.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)
# Set before the first build to have ptxas report, per kernel, its
# registers, spills and shared memory into ptxas_report (the flag is part of
# the library's digest).
report_ptxas = False

# Launch counts per kernel, by kernel name.
launches: dict[str, int] = {
    "fused_track_fast": 0,  # K1
    "preprocess_fwd": 0,  # K2f
    "preprocess_bwd": 0,  # K2b
    "blend_forward": 0,  # K3
    "blend_flat_fwd": 0,  # K4
    "blend_flat_bwd": 0,  # K5
    "blend_backward": 0,  # K6
    "fused_track_exact": 0,  # K7
    "paired_track": 0,  # K8
    "fused_track_ablate": 0,  # K9, every variant
    "map_attr_fwd": 0,  # K10f
    "map_attr_bwd": 0,  # K10b
    "ssim_fwd": 0,  # K11f
    "ssim_bwd": 0,  # K11b
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None
build_seconds_total = 0.0  # every build of this process (a System's compile_s)
# ptxas's report of the last build under report_ptxas (empty when an
# earlier build was reused).
ptxas_report: list[str] = []

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# K9's variants, one entry point each (csrc/fused_track.cu).
ABLATE_VARIANTS = ("full", "fwd", "noexp", "noreduce", "min", "half2")
# K1, K7, K8 and K9's variants share one argument list.
_TRACK_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]
_SIGNATURES = {
    "gsorb_blend_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gsorb_blend_backward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gsorb_blend_flat_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gsorb_blend_flat_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gsorb_fused_track_fast": _TRACK_ARGS,
    "gsorb_fused_track_exact": _TRACK_ARGS,
    "gsorb_paired_track": _TRACK_ARGS,
    **{f"gsorb_fused_track_ablate_{v}": _TRACK_ARGS for v in ABLATE_VARIANTS},
    "gsorb_preprocess_fwd": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P],
    "gsorb_preprocess_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P],
    "gsorb_preprocess_bwd_max_blocks": [],
    "gsorb_map_attr_fwd": [_P] * 9 + [_L] + [_F] * 9 + [_P],
    "gsorb_map_attr_bwd": [_P] * 12 + [_L] + [_F] * 9 + [_P],
    "gsorb_ssim_fwd_blocks": [_I, _I],
    "gsorb_ssim_fwd": [_P] * 9 + [_I] * 3 + [_F] * 2 + [_P],
    "gsorb_ssim_bwd": [_P] * 8 + [_I] * 3 + [_P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _compile_flags() -> tuple[str, ...]:
    return NVCC_FLAGS + (("-Xptxas", "-v") if report_ptxas else ())


def _digest() -> str:
    h = hashlib.sha256(" ".join(_compile_flags()).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path. Reuses an existing library with the same digest."""
    global last_build_seconds, build_seconds_total
    lib_path = BUILD_DIR / f"libgsorb_kernels_{_digest()}.so"
    if lib_path.exists():
        last_build_seconds = 0.0
        return lib_path
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (Path(s).stem + f"_{os.getpid()}.o") for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *_compile_flags(), "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    errors = []
    ptxas_report.clear()
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src}:\n{out}")
        ptxas_report.extend(
            line.replace("ptxas info    : ", "").strip() for line in out.splitlines()
            if "Compiling entry" in line or "registers" in line or "spill" in line
        )
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    build_seconds_total += last_build_seconds
    return lib_path


def pin_full_f32() -> None:
    """Pin float32 matmuls and convolutions on the card to full precision
    (TF32 keeps ~3 decimal digits, which the pose geometry cannot afford,
    and a TF32 keypoint angle moves BRIEF's steered offsets) and cuDNN to
    its deterministic algorithms (the evaluation's MS-SSIM and the plain
    SSIM composite, ``ops.losses.ssim_plain``, run its convolutions; the
    mapping loss's SSIM is K11). Whatever reaches the card first calls it:
    the kernel library and the ORB frontend."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; pins full f32 first
    (:func:`pin_full_f32`)."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            pin_full_f32()
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(
    x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device
) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of this dtype and shape
    on ``device``."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
