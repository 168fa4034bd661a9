"""Pinhole camera model (counterpart of ``gsorb_slam_tpu/core/camera.py``).

The renderer works directly in metric camera space (project with fx/fy,
cull with near/far), so the camera is a frozen dataclass of intrinsics;
poses are passed separately as ``T_cw`` world->camera transforms. Lens
distortion (``Distortion``) applies to the ORB keypoints only: the
frontend undoes it on their coordinates, as the reference's
``Frame::UndistortKeyPoints`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.01
    far: float = 100.0

    @property
    def tan_half_fov_x(self) -> float:
        # tanfov = dim / (2 f), cf. src/Camera.cc:19-20
        return self.width / (2.0 * self.fx)

    @property
    def tan_half_fov_y(self) -> float:
        return self.height / (2.0 * self.fy)

    def K(self, device: torch.device | str = "cuda") -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )

    def scaled(self, factor: float) -> "Camera":
        """Camera for a resolution scaled by ``factor``."""
        return Camera(
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
            near=self.near,
            far=self.far,
        )

    @staticmethod
    def from_config(cfg: Any) -> "Camera":
        """Build from a config mapping with ``Camera.fx`` etc. keys."""
        cam = cfg["Camera"] if "Camera" in cfg else cfg
        return Camera(
            fx=float(cam["fx"]),
            fy=float(cam["fy"]),
            cx=float(cam["cx"]),
            cy=float(cam["cy"]),
            width=int(cam["width"]),
            height=int(cam["height"]),
        )


@dataclasses.dataclass(frozen=True)
class Distortion:
    """Brown-Conrady radial / tangential lens distortion (the reference's
    ``Camera.k1..k3 / p1 / p2`` YAML keys, consumed by
    ``Frame::UndistortKeyPoints`` via ``cv::undistortPoints``)."""

    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    def is_zero(self) -> bool:
        return self.k1 == self.k2 == self.p1 == self.p2 == self.k3 == 0.0


def distort_points(cam: Camera, dist: Distortion, uv: torch.Tensor) -> torch.Tensor:
    """Ideal (pinhole) pixel coords ``[..., 2]`` -> observed (distorted) ones."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (dist.k1 + r2 * (dist.k2 + r2 * dist.k3))
    xd = x * radial + 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
    return torch.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], dim=-1)


def undistort_points(
    cam: Camera, dist: Distortion, uv: torch.Tensor, iters: int = 5
) -> torch.Tensor:
    """Observed (distorted) pixel coords ``[..., 2]`` -> ideal pinhole ones.

    The fixed-point iteration of ``cv::undistortPoints`` (and so of the
    reference's ``Frame::UndistortKeyPoints``): start from the distorted
    normalized coords, then divide out the radial factor and subtract the
    tangential shift. ``iters=5`` is OpenCV's count: with TUM1's strong
    coefficients (k2 = -0.95, k3 = 1.16) the map is not contractive at the
    extreme corners, so more iterations would move away from the reference."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (dist.k1 + r2 * (dist.k2 + r2 * dist.k3))
        dx = 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
        dy = dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
        inv = 1.0 / torch.clamp(radial, min=1e-6)
        x = (xd - dx) * inv
        y = (yd - dy) * inv
    return torch.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], dim=-1)


def undistorted_image_bounds(
    cam: Camera, dist: Distortion
) -> tuple[float, float, float, float]:
    """(min_x, max_x, min_y, max_y) of the undistorted image rectangle
    (``Frame::ComputeImageBounds``: the 4 corners undistorted)."""
    if dist.is_zero():
        return 0.0, float(cam.width), 0.0, float(cam.height)
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]],
        dtype=torch.float32,
    )
    und = undistort_points(cam, dist, corners).numpy()
    return (
        float(min(und[0, 0], und[2, 0])),
        float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])),
        float(max(und[2, 1], und[3, 1])),
    )


def project_points(
    cam: Camera, pts_cam: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project camera-frame points ``[..., 3]`` -> pixel coords ``[..., 2]``, depth ``[...]``."""
    z = pts_cam[..., 2]
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = cam.fx * pts_cam[..., 0] / safe_z + cam.cx
    v = cam.fy * pts_cam[..., 1] / safe_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixel coords ``[..., 2]`` + depth ``[...]`` -> camera-frame points ``[..., 3]``."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def pixel_grid(
    cam: Camera, device: torch.device | str = "cuda", dtype=torch.float32
) -> torch.Tensor:
    """Dense pixel-center coordinates ``[H, W, 2]`` (u=x, v=y)."""
    u = torch.arange(cam.width, dtype=dtype, device=device)
    v = torch.arange(cam.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)
