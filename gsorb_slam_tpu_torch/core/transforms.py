"""Differentiable SE(3)/quaternion math (counterpart of
``gsorb_slam_tpu/core/transforms.py``).

Conventions:
- quaternions are ``[w, x, y, z]``, unnormalized on input (normalized here),
- ``T_cw`` maps world points into the camera frame: ``x_c = R x_w + t``.

Contractions are written as explicit float32 products and sums, so no
TF32 matmul path can round the geometry.
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) along the last axis."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion(s) ``[..., 4]`` -> rotation matrix ``[..., 3, 3]``,
    differentiable through the normalization."""
    q = normalize_quat(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (w>=0).

    Branchless Shepperd method: selects the numerically best of the four
    standard formulas."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(case), 4(comp)]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = normalize_quat(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def pose_to_matrix(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(quat ``[...,4]``, trans ``[...,3]``) -> homogeneous ``T [..., 4, 4]``,
    the differentiable bridge from the optimized pose leaves to the
    renderer's transform."""
    R = quat_to_rotmat(quat)
    batch = torch.broadcast_shapes(R.shape[:-2], trans.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = trans.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Homogeneous ``T [..., 4, 4]`` -> (unit quat ``[...,4]``, trans ``[...,3]``)."""
    return rotmat_to_quat(T[..., :3, :3]), T[..., :3, 3]


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M [..., 3, 3] @ v [..., 3]`` as explicit f32 products."""
    return (M * v[..., None, :]).sum(-1)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid transform(s) ``[..., 4, 4]`` without a linear solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -_matvec(Rt, t)
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    return torch.cat([top, bottom.expand(T.shape[:-2] + (1, 4))], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply ``T [4,4]`` (or batched ``[..., 4, 4]``) to points ``[..., N, 3]``."""
    R = T[..., None, :3, :3]  # [..., 1, 3, 3]
    return (R * pts[..., None, :]).sum(-1) + T[..., None, :3, 3]
