"""The per-instance EWA projection kernel pair (counterpart of
``gsorb_slam_tpu/raster/preprocess_pallas.py``).

- **K2f** (``csrc/preprocess_instances.cu``, ``preprocess_fwd``): raw pack
  ``[T, 16, cap]`` and pose ``rt [12]`` -> screen pack ``[T, 16, cap]``,
  replacing the TPU ``_fwd_kernel``.
- **K2b** (same source, ``preprocess_bwd``): ``d_screen`` -> the 12 pose
  cotangents, replacing the TPU ``_bwd_kernel``: one reverse pass per
  instance and the sum over instances inside the same launch, in a fixed
  order (deterministic). Its per-block rows and its ticket counter are a
  workspace allocated once per device (:func:`_bwd_workspace`).

:func:`preprocess_instances_kernel` is a ``torch.autograd.Function`` whose
forward is K2f and backward K2b on CUDA tensors. On CPU tensors it runs the
plain version, :func:`gsorb_slam_tpu_torch.raster.instances.screen_rows`,
and autograd through it. Gradient contract: only the pose cotangent; the
raw pack gets none (tracking never differentiates it).

:func:`adjoint_edge_pack` makes a raw pack, a pose and a cotangent from a
seed on which K2b takes every branch of its adjoint (near plane, clips,
``det <= 0``, dead slots, zero cotangents); the card's checks and the CPU
tests use it.
"""

from __future__ import annotations

import numpy as np
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
    "adjoint_edge_pack",
    "EDGE_KINDS",
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


# Per device: K2b's block rows [max blocks, 16] and its ticket counter
# (int32, 0 between launches; the kernel's last block resets it).
_BWD_WORK: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _bwd_workspace(dev: torch.device, lib) -> tuple[torch.Tensor, torch.Tensor]:
    work = _BWD_WORK.get(dev)
    if work is None:
        rows = torch.empty((lib.gsorb_preprocess_bwd_max_blocks(), 16), dtype=torch.float32,
                           device=dev)
        work = _BWD_WORK[dev] = (rows, torch.zeros(1, dtype=torch.int32, device=dev))
    return work


def preprocess_bwd(
    raw: torch.Tensor,
    rt: torch.Tensor,
    d_screen: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> torch.Tensor:
    """K2b: launch the pose-adjoint kernel; returns ``d_rt [12]``. One launch
    per call, at ``T = 0`` too (zeros)."""
    n_tiles, cap = _check_inputs(raw, rt)
    _build.check_tensor(
        d_screen, "d_screen", torch.float32, (n_tiles, N_SCREEN, cap), raw.device
    )
    lib = _build.library()
    rows, ticket = _bwd_workspace(raw.device, lib)
    d_rt = torch.empty(12, dtype=torch.float32, device=raw.device)
    _build.count_launch("preprocess_bwd")
    err = lib.gsorb_preprocess_bwd(
        raw.data_ptr(), rt.data_ptr(), d_screen.data_ptr(), d_rt.data_ptr(), rows.data_ptr(),
        ticket.data_ptr(), n_tiles, cap, *_cam_args(cam, scale_modifier),
        _build.stream_handle(raw.device),
    )
    _build.check(err, "preprocess_bwd")
    return d_rt


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


# The kinds of slot in adjoint_edge_pack, by their index in its kind array.
EDGE_KINDS = ("ordinary", "near_plane", "clipped", "det_le_0", "dead", "zero_cotangent")


def _quat_rotations(q: np.ndarray) -> np.ndarray:
    """Unit quaternions ``[n, 4]`` (w, x, y, z) -> rotation matrices ``[n, 3, 3]``."""
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], 1).reshape(-1, 3, 3)


def adjoint_edge_pack(
    seed: int, n_tiles: int, cap: int, cam: Camera
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(raw [T, 16, cap], rt [12], d_screen [T, 16, cap], kind [T, cap])``,
    made with numpy from ``seed`` (float32; ``kind`` indexes
    :data:`EDGE_KINDS`), on which the pose adjoint takes every branch.
    Each slot is one of six kinds, drawn at random: an ordinary instance in
    the view; one whose depth lies around the 0.2 near plane (on both
    sides); one whose ``x / z`` or ``y / z`` (or both) lies past its clip
    ``1.3 tan(fov / 2)`` on either side; one whose world covariance has
    variances +v and -v along two axes of the image plane, so that the
    screen conic's ``det`` is clearly negative (a random indefinite
    covariance would also give near-singular conics with ``det`` just above
    0, whose pose gradients float32 cannot resolve: there the plain version
    itself is 1e-3 from float64); a dead slot (live 0); and a slot whose
    cotangent is zero. Elsewhere each of the six pose cotangent rows is zero
    with probability 0.2, and every other row carries a cotangent too (the
    adjoint must ignore it). The pose is a small rotation and a translation
    of a few cm."""
    rng = np.random.default_rng(seed)
    n = n_tiles * cap
    kind = rng.integers(0, 6, n)
    lim = np.array([1.3 * cam.tan_half_fov_x, 1.3 * cam.tan_half_fov_y])
    z = np.where(kind == 1, rng.uniform(0.1, 0.3, n), rng.uniform(0.8, 4.0, n))
    ratio = rng.uniform(-0.9, 0.9, (n, 2)) * lim
    past = rng.uniform(1.2, 3.0, (n, 2)) * lim * rng.choice([-1.0, 1.0], (n, 2))
    axes = rng.integers(1, 4, n)  # clip x (1), y (2) or both (3)
    for a in range(2):
        clip = (kind == 2) & ((axes >> a) & 1 == 1)
        ratio[:, a] = np.where(clip, past[:, a], ratio[:, a])
    mean = np.stack([ratio[:, 0] * z, ratio[:, 1] * z, z], 1)
    q = rng.normal(size=(n, 4))
    rot = _quat_rotations(q / np.linalg.norm(q, axis=1, keepdims=True))
    var = rng.uniform(0.01, 0.1, (n, 3)) ** 2
    v = rng.uniform(0.05, 0.2, n) ** 2
    ang = rng.uniform(0, np.pi, n)  # a turn about the optical axis
    co, si, zero, one = np.cos(ang), np.sin(ang), np.zeros(n), np.ones(n)
    rot_z = np.stack([co, -si, zero, si, co, zero, zero, zero, one], 1).reshape(n, 3, 3)
    indefinite = kind == 3
    rot[indefinite] = rot_z[indefinite]
    var[indefinite] = np.stack([v, -v, var[:, 2]], 1)[indefinite]
    cov = np.einsum("nij,nj,nkj->nik", rot, var, rot)
    raw = np.zeros((n, 16), np.float64)
    raw[:, 0:3] = mean
    raw[:, 3:6] = rng.uniform(0, 1, (n, 3))
    raw[:, 6:12] = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    raw[:, 12] = rng.normal(size=n)
    raw[:, 13] = np.where(kind == 4, 0.0, 1.0)
    d = rng.normal(size=(n, 16))
    pose_rows = [0, 1, 2, 3, 4, 9]
    d[:, pose_rows] *= rng.uniform(size=(n, 6)) >= 0.2
    d[kind == 5] = 0.0
    h = np.array([[1.0, 0.02, -0.03, 0.01]])
    R = _quat_rotations(h / np.linalg.norm(h))[0]
    rt = np.concatenate([R.reshape(-1), [0.03, -0.02, 0.05]]).astype(np.float32)

    def tiles(a):
        return np.ascontiguousarray(a.reshape(n_tiles, cap, 16).transpose(0, 2, 1), np.float32)

    return tiles(raw), rt, tiles(d), kind.reshape(n_tiles, cap)


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
