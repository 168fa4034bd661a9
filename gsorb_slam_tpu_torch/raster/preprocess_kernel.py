"""The per-instance EWA projection kernel pair (counterpart of
``gsorb_slam_tpu/raster/preprocess_pallas.py``).

- **K2f** (``csrc/preprocess_instances.cu``, ``preprocess_fwd``): raw pack
  ``[T, 16, cap]`` and pose ``rt [12]`` -> screen pack ``[T, 16, cap]``,
  replacing the TPU ``_fwd_kernel``.
- **K2b** (same source, ``preprocess_bwd``): ``d_screen`` -> the 12 pose
  cotangents, replacing the TPU ``_bwd_kernel``. Per-block partial sums come
  out of the kernel; the final fixed-order ``torch.sum`` keeps the result
  deterministic.

:func:`preprocess_instances_kernel` is a ``torch.autograd.Function`` whose
forward is K2f and backward K2b on CUDA tensors. On CPU tensors it runs the
plain version, :func:`gsorb_slam_tpu_torch.raster.instances.screen_rows`,
and autograd through it. Gradient contract: only the pose cotangent; the
raw pack gets none (tracking never differentiates it).
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.instances import N_RAW, rt_from_matrix, screen_rows

N_SCREEN = 16

__all__ = [
    "preprocess_instances_kernel",
    "preprocess_fwd",
    "preprocess_bwd",
    "preprocess_bwd_plain",
    "rt_from_matrix",
]


def _cam_args(cam: Camera, scale_modifier: float) -> tuple[float, ...]:
    return (
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        1.3 * cam.tan_half_fov_x, 1.3 * cam.tan_half_fov_y, float(scale_modifier),
    )


def _check_inputs(raw: torch.Tensor, rt: torch.Tensor) -> tuple[int, int]:
    n_tiles, rows, cap = raw.shape
    _build.check_tensor(raw, "raw", torch.float32, (n_tiles, N_RAW, cap), raw.device)
    _build.check_tensor(rt, "rt", torch.float32, (12,), raw.device)
    return n_tiles, cap


def preprocess_fwd(
    raw: torch.Tensor, rt: torch.Tensor, cam: Camera, scale_modifier: float = 1.0
) -> torch.Tensor:
    """K2f: launch the forward projection kernel (CUDA tensors only)."""
    n_tiles, cap = _check_inputs(raw, rt)
    out = torch.empty((n_tiles, N_SCREEN, cap), dtype=torch.float32, device=raw.device)
    lib = _build.library()
    _build.count_launch("preprocess_fwd")
    err = lib.gsorb_preprocess_fwd(
        raw.data_ptr(), rt.data_ptr(), out.data_ptr(), n_tiles, cap,
        *_cam_args(cam, scale_modifier), _build.stream_handle(raw.device),
    )
    _build.check(err, "preprocess_fwd")
    return out


def preprocess_bwd(
    raw: torch.Tensor,
    rt: torch.Tensor,
    d_screen: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> torch.Tensor:
    """K2b: launch the pose-adjoint kernel; returns ``d_rt [12]``."""
    n_tiles, cap = _check_inputs(raw, rt)
    _build.check_tensor(
        d_screen, "d_screen", torch.float32, (n_tiles, N_SCREEN, cap), raw.device
    )
    lib = _build.library()
    n_blocks = lib.gsorb_preprocess_blocks(n_tiles * cap)
    partials = torch.empty((max(n_blocks, 1), 12), dtype=torch.float32, device=raw.device)
    if n_blocks == 0:
        partials.zero_()
    _build.count_launch("preprocess_bwd")
    err = lib.gsorb_preprocess_bwd(
        raw.data_ptr(), rt.data_ptr(), d_screen.data_ptr(), partials.data_ptr(),
        n_tiles, cap, *_cam_args(cam, scale_modifier), _build.stream_handle(raw.device),
    )
    _build.check(err, "preprocess_bwd")
    return partials.sum(0)


def preprocess_bwd_plain(
    raw: torch.Tensor,
    rt: torch.Tensor,
    d_screen: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> torch.Tensor:
    """K2b's plain version: autograd of :func:`screen_rows` w.r.t. ``rt``."""
    with torch.enable_grad():
        rt_ = rt.detach().requires_grad_(True)
        out = screen_rows(raw.detach(), rt_, cam, scale_modifier)
        (d_rt,) = torch.autograd.grad(out, rt_, d_screen)
    return d_rt


class _PreprocessInstances(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw, rt, cam, scale_modifier):
        ctx.save_for_backward(raw, rt)
        ctx.cam = cam
        ctx.scale_modifier = scale_modifier
        if raw.is_cuda:
            return preprocess_fwd(raw, rt.contiguous(), cam, scale_modifier)
        return screen_rows(raw, rt, cam, scale_modifier)

    @staticmethod
    def backward(ctx, d_screen):
        raw, rt = ctx.saved_tensors
        if raw.is_cuda:
            d_rt = preprocess_bwd(
                raw, rt.contiguous(), d_screen.contiguous(), ctx.cam, ctx.scale_modifier
            )
        else:
            d_rt = preprocess_bwd_plain(raw, rt, d_screen, ctx.cam, ctx.scale_modifier)
        return None, d_rt, None, None


def preprocess_instances_kernel(
    raw: torch.Tensor, rt: torch.Tensor, cam: Camera, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Screen pack ``[T, 16, cap]`` of the raw pack at pose ``rt`` (flat R
    row-major, then t), differentiable w.r.t. ``rt``: K2f/K2b on CUDA, the
    plain version on the CPU."""
    return _PreprocessInstances.apply(raw.detach(), rt, cam, scale_modifier)
