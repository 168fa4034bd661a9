"""Pinhole camera model (counterpart of ``gsorb_slam_tpu/core/camera.py``).

The renderer works directly in metric camera space (project with fx/fy,
cull with near/far), so the camera is a frozen dataclass of intrinsics;
poses are passed separately as ``T_cw`` world->camera transforms. Lens
distortion is handled by the ORB frontend and is not part of this module
yet.
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
