"""Per-Gaussian EWA projection ("preprocess"), counterpart of
``gsorb_slam_tpu/raster/preprocess.py``.

Equivalent of ``preprocessCUDA`` + ``computeCov2D`` + ``computeCov3D``
(``cuda_rasterizer/forward.cu:74-256``): frustum cull, perspective
projection, 3D covariance from quaternion*scale, EWA 2D covariance with the
0.3 pixel low-pass, conic inverse and 3-sigma radius.

As in the JAX package, the covariance is always rotated into the camera
frame, ``cov_cam = R_cw cov_world R_cw^T``, which matches the reference's
radius-filter path and is differentiable w.r.t. the pose. All products are
written out element by element in float32.
"""

from __future__ import annotations

import dataclasses

import torch

from gsorb_slam_tpu_torch.core.camera import Camera

NEAR_CULL = 0.2  # CUDA in_frustum: p_view.z <= 0.2 culled (auxiliary.h)
LOW_PASS = 0.3  # pixel low-pass added to cov2D diagonal (forward.cu:108-110)


@dataclasses.dataclass
class Preprocessed:
    """Screen-space Gaussian attributes, padded to capacity C."""

    mean2d: torch.Tensor  # [C, 2] pixel coords
    depth: torch.Tensor  # [C] camera z (+inf for culled)
    conic: torch.Tensor  # [C, 3] upper-triangular inverse cov2D (a, b, c)
    opacity: torch.Tensor  # [C] sigmoid-activated
    color: torch.Tensor  # [C, 3]
    radius: torch.Tensor  # [C] float pixel radius (0 for culled)
    valid: torch.Tensor  # [C] bool

    def detach(self) -> "Preprocessed":
        return Preprocessed(
            **{f.name: getattr(self, f.name).detach() for f in dataclasses.fields(self)}
        )


def rotation_entries(quats: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The nine entries (row-major) of the rotation matrix of each
    unnormalized quaternion ``[C, 4]``, scalar-expanded."""
    qw, qx, qy, qz = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    qn = torch.clamp(torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), min=1e-12)
    w_, xq, yq, zq = qw / qn, qx / qn, qy / qn, qz / qn
    r00 = 1 - 2 * (yq * yq + zq * zq)
    r01 = 2 * (xq * yq - w_ * zq)
    r02 = 2 * (xq * zq + w_ * yq)
    r10 = 2 * (xq * yq + w_ * zq)
    r11 = 1 - 2 * (xq * xq + zq * zq)
    r12 = 2 * (yq * zq - w_ * xq)
    r20 = 2 * (xq * zq - w_ * yq)
    r21 = 2 * (yq * zq + w_ * xq)
    r22 = 1 - 2 * (xq * xq + yq * yq)
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def preprocess(
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> Preprocessed:
    R_cw = T_cw[:3, :3]
    t_cw = T_cw[:3, 3]
    x, y, z = means[:, 0], means[:, 1], means[:, 2]
    tx = R_cw[0, 0] * x + R_cw[0, 1] * y + R_cw[0, 2] * z + t_cw[0]
    ty = R_cw[1, 0] * x + R_cw[1, 1] * y + R_cw[1, 2] * z + t_cw[1]
    tz = R_cw[2, 0] * x + R_cw[2, 1] * y + R_cw[2, 2] * z + t_cw[2]

    in_front = tz > NEAR_CULL
    safe_z = torch.where(in_front, tz, torch.ones_like(tz))

    # EWA Jacobian with the CUDA 1.3*tan_fov clamp (forward.cu:80-92).
    lim_x = 1.3 * cam.tan_half_fov_x
    lim_y = 1.3 * cam.tan_half_fov_y
    txz = torch.clamp(tx / safe_z, -lim_x, lim_x)
    tyz = torch.clamp(ty / safe_z, -lim_y, lim_y)

    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_entries(quats)
    e0 = torch.exp(log_scales[:, 0]) * scale_modifier
    e1 = torch.exp(log_scales[:, 1]) * scale_modifier
    e2 = torch.exp(log_scales[:, 2]) * scale_modifier
    v0, v1, v2 = e0 * e0, e1 * e1, e2 * e2
    c00 = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2
    c01 = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2
    c02 = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2
    c11 = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2
    c12 = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2
    c22 = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2
    R = R_cw
    # cov_cam = R_cw cov_w R_cw^T (row-expanded)
    m00 = R[0, 0] * c00 + R[0, 1] * c01 + R[0, 2] * c02
    m01 = R[0, 0] * c01 + R[0, 1] * c11 + R[0, 2] * c12
    m02 = R[0, 0] * c02 + R[0, 1] * c12 + R[0, 2] * c22
    m10 = R[1, 0] * c00 + R[1, 1] * c01 + R[1, 2] * c02
    m11 = R[1, 0] * c01 + R[1, 1] * c11 + R[1, 2] * c12
    m12 = R[1, 0] * c02 + R[1, 1] * c12 + R[1, 2] * c22
    m20 = R[2, 0] * c00 + R[2, 1] * c01 + R[2, 2] * c02
    m21 = R[2, 0] * c01 + R[2, 1] * c11 + R[2, 2] * c12
    m22 = R[2, 0] * c02 + R[2, 1] * c12 + R[2, 2] * c22
    k00 = m00 * R[0, 0] + m01 * R[0, 1] + m02 * R[0, 2]
    k01 = m00 * R[1, 0] + m01 * R[1, 1] + m02 * R[1, 2]
    k02 = m00 * R[2, 0] + m01 * R[2, 1] + m02 * R[2, 2]
    k11 = m10 * R[1, 0] + m11 * R[1, 1] + m12 * R[1, 2]
    k12 = m10 * R[2, 0] + m11 * R[2, 1] + m12 * R[2, 2]
    k22 = m20 * R[2, 0] + m21 * R[2, 1] + m22 * R[2, 2]

    fx_z = cam.fx / safe_z
    fy_z = cam.fy / safe_z
    # J = [[fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2]]
    j02 = -fx_z * txz
    j12 = -fy_z * tyz
    a = fx_z * (fx_z * k00 + j02 * k02) + j02 * (fx_z * k02 + j02 * k22) + LOW_PASS
    b = fx_z * (fy_z * k01 + j12 * k02) + j02 * (fy_z * k12 + j12 * k22)
    c = fy_z * (fy_z * k11 + j12 * k12) + j12 * (fy_z * k12 + j12 * k22) + LOW_PASS

    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # radius = ceil(3 sqrt(max eigenvalue)) (forward.cu:176-181), tightened
    # by opacity: alpha(d) falls below the blend's 1/255 skip at
    # d = sqrt(2 lam1 ln(255 op)).
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    op = torch.sigmoid(logit_opacities)
    ln_term = torch.log(torch.clamp(255.0 * op, min=1e-6))
    cutoff = torch.sqrt(2.0 * lam1 * torch.clamp(ln_term, min=0.0))
    radius = torch.ceil(torch.minimum(3.0 * torch.sqrt(lam1), cutoff))

    # Center projected unclamped; the clamp is only for the EWA Jacobian.
    u = cam.fx * (tx / safe_z) + cam.cx
    v = cam.fy * (ty / safe_z) + cam.cy
    mean2d = torch.stack([u, v], dim=-1)

    on_screen = (
        (u + radius > 0)
        & (u - radius < cam.width)
        & (v + radius > 0)
        & (v - radius < cam.height)
    )
    # op < 1/255 can never pass the blend's alpha skip anywhere: cull.
    valid = active & in_front & det_ok & on_screen & (op >= 1.0 / 255.0)

    return Preprocessed(
        mean2d=mean2d,
        depth=torch.where(valid, tz, torch.full_like(tz, float("inf"))),
        conic=conic,
        opacity=op,
        color=rgb,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        valid=valid,
    )
