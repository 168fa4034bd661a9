"""Generated RGB-D sequences (counterpart of the generators in
``gsorb_slam_tpu/slam/dataset.py``).

Every dataset yields :class:`RGBDFrame` ``(timestamp, rgb [H, W, 3] f32 in
[0, 1], depth [H, W] f32 meters)`` with the ground-truth pose. Both
generators are made from a numpy seed and render their frames with the
port's :func:`~gsorb_slam_tpu_torch.raster.render` on ``device`` (K3 on the
card), with the JAX package's raster configuration; the numpy draws follow
the JAX package's order, so the same seed gives the same scene, trajectory
and noise. The TUM, Replica and ScanNet disk loaders are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster import RasterConfig, render


@dataclasses.dataclass
class RGBDFrame:
    timestamp: float
    rgb: np.ndarray  # [H, W, 3] float32 in [0, 1]
    depth: np.ndarray  # [H, W] float32 meters (0 = invalid)
    gt_T_cw: Optional[np.ndarray] = None  # [4, 4] if ground truth known


class RGBDDataset:
    """Base: sequence of RGBDFrames + optional GT trajectory."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> RGBDFrame:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RGBDFrame]:
        for i in range(len(self)):
            yield self[i]


def _quat_to_R(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def _renderer(means, rgb, quats, logit_op, log_scales, cam: Camera, rcfg: RasterConfig, device):
    """A function ``T_cw [4, 4] numpy -> RenderOutput`` over a fixed splat set."""
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    params = (t(means), t(rgb), t(quats), t(logit_op), t(log_scales),
              torch.ones(len(means), dtype=torch.bool, device=device))

    def rfn(T_cw: np.ndarray):
        with torch.no_grad():
            return render(*params, t(np.asarray(T_cw, np.float32)), cam, rcfg)

    return rfn


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class SyntheticDataset(RGBDDataset):
    """Procedural RGB-D sequence rendered from a random Gaussian scene along
    a smooth trajectory (the tests' and smoke runs' stand-in for real data)."""

    def __init__(
        self,
        cam: Camera,
        n_frames: int = 30,
        n_splats: int = 4000,
        seed: int = 0,
        motion_scale: float = 1.0,
        scale_range: tuple = (0.03, 0.08),
        trajectory=None,  # optional [N, 4, 4] T_cw list overriding the sweep
        device: torch.device | str = "cuda",
    ):
        self.cam = cam
        rng = np.random.default_rng(seed)
        means = np.stack(
            [
                rng.uniform(-2.0, 2.0, n_splats),
                rng.uniform(-1.5, 1.5, n_splats),
                rng.uniform(1.2, 4.0, n_splats),
            ],
            -1,
        ).astype(np.float32)
        rgb = rng.uniform(0.05, 1.0, (n_splats, 3)).astype(np.float32)
        quats = rng.normal(size=(n_splats, 4)).astype(np.float32)
        logit_op = np.full(n_splats, 6.0, np.float32)  # nearly opaque surface
        log_scales = np.log(rng.uniform(*scale_range, (n_splats, 3)).astype(np.float32))

        rcfg = RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128)
        rfn = _renderer(means, rgb, quats, logit_op, log_scales, cam, rcfg, device)
        self.poses = []
        frames = []
        if trajectory is not None:
            n_frames = len(trajectory)
        for i in range(n_frames):
            if trajectory is not None:
                T_cw = np.asarray(trajectory[i], np.float32)
            else:
                s = i / max(n_frames - 1, 1)
                T_cw = np.eye(4, dtype=np.float32)
                ang = 0.12 * motion_scale * np.sin(2 * np.pi * s)
                ca, sa = np.cos(ang), np.sin(ang)
                T_cw[:3, :3] = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], np.float32)
                T_cw[:3, 3] = [
                    0.25 * motion_scale * np.sin(2 * np.pi * s),
                    0.08 * motion_scale * np.sin(4 * np.pi * s),
                    0.15 * motion_scale * s,
                ]
            out = rfn(T_cw)
            color = np.clip(_host(out.color), 0, 1)
            depth = np.where(_host(out.alpha) > 0.5, _host(out.median_depth), 0.0)
            frames.append((color, depth))
            self.poses.append(T_cw)
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        color, depth = self.frames[i]
        return RGBDFrame(timestamp=float(i), rgb=color, depth=depth, gt_T_cw=self.poses[i])


class TUMLikeDataset(RGBDDataset):
    """TUM-fr1-like sequence generated from a seed: TUM1's intrinsics, a
    speckle-textured room with cuboid clutter made of a dense splat surface,
    a handheld trajectory (a smooth sweep plus ~1 cm per frame of smoothed
    shake) and the Kinect noise model (depth sigma(z) = 0.0012 + 0.0019
    (z - 0.4)^2 m, 1/5000 m quantization, 1% dropout; rgb shot noise).

    ``apply_distortion=True`` (TUM1's Brown-Conrady distortion warped into
    the images) raises for now: it needs ``undistort_points``, which comes
    with the ORB slice, and an image remap."""

    # TUM1 calibration (Examples/RGB-D/tum/TUM1.yaml)
    FX, FY, CX, CY = 517.306408, 516.469215, 318.643040, 255.313989

    def __init__(
        self,
        n_frames: int = 100,
        seed: int = 0,
        width: int = 640,
        height: int = 480,
        apply_distortion: bool = True,
        noise: bool = True,
        splat_spacing: float = 0.02,
        device: torch.device | str = "cuda",
    ):
        if apply_distortion:
            raise NotImplementedError(
                "TUMLikeDataset(apply_distortion=True) needs undistort_points (the ORB "
                "slice) and an image remap; pass apply_distortion=False"
            )
        s = width / 640.0
        self.cam = Camera(fx=self.FX * s, fy=self.FY * s, cx=self.CX * s, cy=self.CY * s,
                          width=width, height=height)
        rng = np.random.default_rng(seed)

        means, rgb = self._build_room(rng, splat_spacing)
        n = len(means)
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        logit_op = np.full(n, 7.0, np.float32)
        log_scales = np.log(np.full((n, 3), splat_spacing * 0.9, np.float32))
        rcfg = RasterConfig(tile=16, tile_capacity=2048, max_dup=16, chunk=256, dilate_px=2.0)
        rfn = _renderer(means, rgb, quats, logit_op, log_scales, self.cam, rcfg, device)

        self.poses = []
        self.frames = []
        jitter = rng.normal(0, 1, (n_frames, 6)).astype(np.float32)
        # smooth the jitter (handheld shake is low-frequency); kernel no
        # longer than the sequence (np.convolve 'same' requires it)
        kw = min(7, n_frames)
        k = np.ones(kw) / kw
        for c in range(6):
            jitter[:, c] = np.convolve(jitter[:, c], k, mode="same")
        for i in range(n_frames):
            t = i / max(n_frames - 1, 1)
            T_cw = self._pose(t, jitter[i])
            out = rfn(T_cw)
            color = np.clip(_host(out.color), 0, 1)
            depth = np.where(_host(out.alpha) > 0.5, _host(out.median_depth), 0.0)
            if noise:
                sig = 0.0012 + 0.0019 * np.square(np.maximum(depth - 0.4, 0.0))
                depth = depth + rng.normal(0, 1, depth.shape) * sig
                depth = np.round(depth * 5000.0) / 5000.0  # sensor quantization
                drop = rng.uniform(size=depth.shape) < 0.01
                depth = np.where(drop | (depth <= 0.05), 0.0, depth)
                color = np.clip(color + rng.normal(0, 0.008, color.shape), 0, 1).astype(np.float32)
            self.frames.append((color.astype(np.float32), depth.astype(np.float32)))
            self.poses.append(T_cw)

    def _build_room(self, rng, spacing):
        """Speckle-textured room surfaces + clutter as a dense splat cloud."""

        def speckle(base, pts, scale=1.5):
            # hash-based per-cell color speckle (stable, high-contrast for FAST)
            cells = np.floor(pts * 12.0).astype(np.int64)
            h = (cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663) ^ (cells[:, 2] * 83492791)
            u = ((h % 1000) / 1000.0).astype(np.float32)
            col = np.asarray(base, np.float32)[None] * (0.45 + 0.9 * u[:, None])
            tint = np.stack(
                [((h >> 3) % 7) / 7.0, ((h >> 6) % 5) / 5.0, ((h >> 9) % 9) / 9.0], -1,
            ).astype(np.float32)
            return np.clip(0.75 * col + 0.25 * tint, 0.02, 1.0)

        def plane(p0, du, dv, nu, nv, base):
            uu, vv = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
            pts = (
                np.asarray(p0)[None]
                + uu.reshape(-1, 1) * np.asarray(du)[None]
                + vv.reshape(-1, 1) * np.asarray(dv)[None]
            ).astype(np.float32)
            pts += rng.normal(0, spacing * 0.15, pts.shape).astype(np.float32)
            return pts, speckle(base, pts)

        n_of = lambda length: max(int(length / spacing), 2)
        parts = [
            # floor y=+1.1, 6m x 5m
            plane([-3.0, 1.1, 0.5], [6, 0, 0], [0, 0, 5], n_of(6), n_of(5), [0.55, 0.45, 0.35]),
            # back wall z=5.5
            plane([-3.0, -1.6, 5.5], [6, 0, 0], [0, 2.7, 0], n_of(6), n_of(2.7),
                  [0.75, 0.72, 0.65]),
            # left wall x=-3
            plane([-3.0, -1.6, 0.5], [0, 0, 5], [0, 2.7, 0], n_of(5), n_of(2.7),
                  [0.62, 0.68, 0.72]),
            # right wall x=+3
            plane([3.0, -1.6, 0.5], [0, 0, 5], [0, 2.7, 0], n_of(5), n_of(2.7),
                  [0.7, 0.62, 0.58]),
        ]
        # clutter: cuboid faces at random poses (desk-scene stand-ins)
        for _ in range(25):
            c = np.array([rng.uniform(-2.2, 2.2), rng.uniform(0.2, 1.0), rng.uniform(1.2, 4.6)])
            sz = rng.uniform(0.12, 0.5, 3)
            base = rng.uniform(0.15, 0.95, 3)
            for axis in range(3):
                for sgn in (-1, 1):
                    du = np.zeros(3)
                    dv = np.zeros(3)
                    du[(axis + 1) % 3] = sz[(axis + 1) % 3]
                    dv[(axis + 2) % 3] = sz[(axis + 2) % 3]
                    p0 = c - du / 2 - dv / 2
                    p0[axis] += sgn * sz[axis] / 2
                    parts.append(
                        plane(p0, du, dv,
                              max(int(np.linalg.norm(du) / spacing), 2),
                              max(int(np.linalg.norm(dv) / spacing), 2), base)
                    )
        means = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        return means.astype(np.float32), cols.astype(np.float32)

    def _pose(self, t, jit6):
        """fr1-like handheld sweep: orbit segment + smoothed shake."""
        ang = 0.5 * np.sin(2 * np.pi * t * 0.7) + 0.015 * jit6[3]
        tilt = 0.08 * np.sin(2 * np.pi * t * 1.3) + 0.01 * jit6[4]
        roll = 0.03 * np.sin(2 * np.pi * t * 2.1) + 0.008 * jit6[5]
        ca, sa = np.cos(ang), np.sin(ang)
        cb, sb = np.cos(tilt), np.sin(tilt)
        cr, sr = np.cos(roll), np.sin(roll)
        Ry = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]], np.float32)
        Rx = np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]], np.float32)
        Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rz @ Rx @ Ry
        T[:3, 3] = [
            0.8 * np.sin(2 * np.pi * t * 0.5) + 0.008 * jit6[0],
            0.15 * np.sin(2 * np.pi * t * 1.1) + 0.006 * jit6[1],
            0.45 * np.sin(2 * np.pi * t * 0.35) + 0.008 * jit6[2],
        ]
        return T

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        color, depth = self.frames[i]
        return RGBDFrame(timestamp=float(i) / 30.0, rgb=color, depth=depth, gt_T_cw=self.poses[i])
