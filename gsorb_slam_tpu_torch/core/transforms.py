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


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions ``[..., 4]`` (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


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


def _matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A [..., n, k] @ B [..., k, m]`` as explicit f32 products."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def skew(w: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> skew-symmetric ``[..., 3, 3]``."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues: axis-angle ``[..., 3]`` -> rotation matrix ``[..., 3, 3]``
    (the g2o ``SE3Quat::exp`` equivalent used by the pose solvers)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    safe = torch.clamp(theta, min=eps)
    big = theta[..., None] > eps
    a = torch.where(big, (torch.sin(safe) / safe)[..., None], torch.ones_like(big, dtype=w.dtype))
    b = torch.where(big, ((1.0 - torch.cos(safe)) / (safe * safe))[..., None],
                    torch.full_like(big, 0.5, dtype=w.dtype))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * _matmul3(K, K)


def so3_log(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> axis-angle ``[..., 3]``."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)[..., None]
    th = theta[..., None]
    scale = torch.where(th > eps, th / (2.0 * torch.clamp(sin_t, min=eps)),
                        torch.full_like(th, 0.5))
    return w * scale


def se3_log(T: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Rigid transform ``[..., 4, 4]`` -> twist ``[..., 6]`` (rho, phi).

    ``eps`` gates the small-angle Taylor branch: in f32 the closed form
    ``(1 - theta sin / (2 (1 - cos))) / theta^2`` cancels catastrophically
    below ~1e-3 rad, so the threshold is deliberately wide."""
    phi = so3_log(T[..., :3, :3], eps)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    safe = torch.clamp(theta, min=eps)
    K = skew(phi)
    half_cot = torch.where(
        theta[..., None] > eps,
        ((1.0 - safe * torch.sin(safe) / (2.0 * (1.0 - torch.cos(safe)))) / (safe * safe))[..., None],
        torch.full_like(theta[..., None], 1.0 / 12.0),
    )
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    Vinv = eye - 0.5 * K + half_cot * _matmul3(K, K)
    return torch.cat([_matvec(Vinv, T[..., :3, 3]), phi], dim=-1)


def se3_exp(xi: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """se(3) twist ``[..., 6]`` (rho, phi) -> ``T [..., 4, 4]``."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi, eps)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    safe = torch.clamp(theta, min=eps)
    big = theta[..., None] > eps
    K = skew(phi)
    b = torch.where(big, ((1.0 - torch.cos(safe)) / (safe * safe))[..., None],
                    torch.full_like(big, 0.5, dtype=xi.dtype))
    c = torch.where(big, ((safe - torch.sin(safe)) / safe**3)[..., None],
                    torch.full_like(big, 1.0 / 6.0, dtype=xi.dtype))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + b * K + c * _matmul3(K, K)
    t = _matvec(V, rho)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom.expand(xi.shape[:-1] + (1, 4))], dim=-2)
