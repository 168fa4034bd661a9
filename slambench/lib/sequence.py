"""The one generator of the benchmark's RGB-D and stereo sequences.

A traffic file (``slambench/traffic/<cell>.json``) names a scene and sets
the camera path, the handheld shake and the sensor; the configuration
gives the camera (intrinsics, Brown-Conrady distortion, depth factor) and
the sensor: ``"sensor": "stereo"`` (absent: ``"rgbd"``) makes a rectified
pair with the baseline ``Camera.bf / fx``. Everything is drawn on the
device from ``--seed`` with one ``torch.Generator`` for the path and one
for each view's sensor noise: the same seed gives the same frames, bit for
bit.

The path is an orbit around ``path.center`` at ``path.radius_m`` and
``path.height_m``, ``path.step_mm`` of arc a frame; the yaw rate is
``step_mm / radius_m``. The camera looks at ``path.look_at`` (swaying by
``path.look_sway_m`` over ``path.look_sway_frames``), or, with
``path.heading: "travel"``, along the orbit's tangent pitched down by
``path.pitch_deg`` (a large radius is then a gently curving road). The
seed adds shake: Gaussian noise smoothed over ``shake.smooth_frames``
frames, scaled to ``shake.trans_mm`` and ``shake.rot_deg`` (standard
deviations). The seed draws the same number of values whatever it is, so
every seed gives the same amount of work.

Frames are held on the host as the sensor gives them: ``uint8`` colour
(``sensor.gray``: luminance, ``[H, W]``) and ``uint16`` depth (metres x
``depth_factor``, 0 = no reading). A stereo rig's right view is ray-cast
at the left pose moved ``+baseline`` along the camera's x axis, with the
same intrinsics and colour noise of its own; the left view's true depth is
kept for the PSNR mask only and is never handed to the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from slambench.lib.scene import Scene, cast


@dataclass
class CameraModel:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple[float, float, float, float, float]  # k1, k2, p1, p2, k3
    depth_factor: float
    fps: float
    bf: float = 0.0  # stereo: baseline x fx (Camera.bf)


@dataclass
class Sequence:
    colors: np.ndarray  # [N, H, W, 3] uint8, or [N, H, W] gray; the left view of a pair
    depths: np.ndarray  # [N, H, W] uint16
    T_cw: np.ndarray  # [N, 4, 4] float64, ground truth (world -> camera)
    timestamps: np.ndarray  # [N] seconds
    depth_factor: float
    rights: np.ndarray | None = None  # stereo: the right view, as ``colors``


SENSORS = ("rgbd", "stereo")
RIGHT_SALT = 0x5EED ^ 0x2161  # the right view's noise generator


def sensor_of(cfg: dict) -> str:
    """A configuration file's sensor (``"rgbd"`` where it names none). A
    rectified stereo pair has no distortion: a stereo configuration with a
    nonzero ``Camera.k*`` / ``Camera.p*`` raises, as does one without
    ``Camera.bf``."""
    sensor = cfg.get("sensor", "rgbd")
    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r}: one of {SENSORS}")
    if sensor == "stereo":
        sysc = cfg["system"]
        bent = {k: sysc[k] for k in ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2",
                                     "Camera.k3") if float(sysc.get(k, 0.0)) != 0.0}
        if bent:
            raise ValueError(f"a stereo configuration is rectified, without distortion: {bent}")
        if float(sysc.get("Camera.bf", 0.0)) <= 0.0:
            raise ValueError("a stereo configuration needs Camera.bf > 0")
    return sensor


def camera_from_config(cfg: dict) -> CameraModel:
    cam = cfg["Camera"]
    return CameraModel(
        width=int(cam["width"]), height=int(cam["height"]), fx=float(cam["fx"]),
        fy=float(cam["fy"]), cx=float(cam["cx"]), cy=float(cam["cy"]),
        dist=tuple(float(cfg.get(f"Camera.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")),
        depth_factor=float(cfg["DepthMapFactor"]), fps=float(cam["fps"]),
        bf=float(cfg.get("Camera.bf", 0.0)),
    )


def undistort_pixels(cam: CameraModel, u: torch.Tensor, v: torch.Tensor, iters: int = 5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Observed (distorted) pixel coordinates -> ideal pinhole ones, by the
    fixed-point iteration of OpenCV's ``undistortPoints`` (5 rounds)."""
    k1, k2, p1, p2, k3 = cam.dist
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / torch.clamp(radial, min=1e-6)
        x = (xd - dx) * inv
        y = (yd - dy) * inv
    return cam.fx * x + cam.cx, cam.fy * y + cam.cy


def look_at(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """T_cw of a camera at ``center`` looking at ``target`` in a z-up world
    (camera x right, y down, z forward)."""
    f = target - center
    f = f / np.linalg.norm(f)
    x = np.cross(f, np.array([0.0, 0.0, 1.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(f, x)
    R_wc = np.stack([x, y, f], axis=1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ center
    return T


def _rotvec(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def trajectory(traffic: dict, seed: int, device: torch.device) -> np.ndarray:
    """Ground-truth ``T_cw [N, 4, 4]`` (float64) of the traffic's path with
    the seed's shake."""
    path, shake = traffic["path"], traffic["shake"]
    n = int(traffic["n_frames"])
    sm = int(shake["smooth_frames"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    raw = torch.randn((n + sm, 6), generator=gen, device=device, dtype=torch.float64)
    kern = torch.ones((1, 1, sm), device=device, dtype=torch.float64) / sm
    smooth = torch.nn.functional.conv1d(raw.T[:, None, :], kern)[:, 0, :n].T  # [n, 6]
    smooth = smooth / smooth.std(dim=0, keepdim=True).clamp(min=1e-12)
    smooth = smooth.cpu().numpy()
    center = np.asarray(path["center"], np.float64)
    r = float(path["radius_m"])
    step = float(path["step_mm"]) / 1000.0 / r  # radians of orbit a frame
    a0 = math.radians(float(path["start_deg"]))
    sway = float(path.get("look_sway_m", 0.0))
    sway_n = float(path.get("look_sway_frames", 1.0))
    heading = path.get("heading", "look_at")
    if heading not in ("look_at", "travel"):
        raise ValueError(f"path.heading {heading!r}: 'look_at' or 'travel'")
    pitch = math.radians(float(path.get("pitch_deg", 0.0)))
    target0 = np.asarray(path["look_at"], np.float64) if heading == "look_at" else None
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        a = a0 + i * step
        c = center + np.array([r * math.cos(a), r * math.sin(a), 0.0])
        c[2] = float(path["height_m"])
        if heading == "travel":
            # Along the orbit's tangent (the direction of motion), pitched down.
            ahead = np.array([-math.sin(a), math.cos(a), 0.0])
            target = c + math.cos(pitch) * ahead - np.array([0.0, 0.0, math.sin(pitch)])
        else:
            s = sway * math.sin(2.0 * math.pi * i / sway_n)
            target = target0 + np.array([-s * math.sin(a), s * math.cos(a), 0.0])
        T = look_at(c, target)
        dt = smooth[i, :3] * float(shake["trans_mm"]) / 1000.0
        dw = smooth[i, 3:] * math.radians(float(shake["rot_deg"]))
        D = np.eye(4)
        D[:3, :3] = _rotvec(dw)
        D[:3, 3] = dt
        poses[i] = D @ T
    return poses


def render_frames(scene: Scene, cam: CameraModel, poses: np.ndarray, sensor: dict, seed: int,
                  device: torch.device, batch: int = 8, salt: int = 0x5EED
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Colour ``uint8 [N, H, W, 3]`` (``sensor.gray``: luminance ``[N, H,
    W]``) and depth ``uint16 [N, H, W]`` of the scene at ``poses``, with the
    sensor's noise drawn from ``seed`` (a generator of its own, salted by
    ``salt``, so the noise does not depend on the path)."""
    H, W = cam.height, cam.width
    n = poses.shape[0]
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ salt)
    vv, uu = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    if any(cam.dist):
        uu, vv = undistort_pixels(cam, uu, vv)
    d_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                         torch.ones_like(uu)], -1).reshape(-1, 3)
    gray = bool(sensor.get("gray", False))
    colors = np.zeros((n, H, W) if gray else (n, H, W, 3), np.uint8)
    depths = np.zeros((n, H, W), np.uint16)
    kind = sensor.get("depth_noise", "none")
    dropout = float(sensor.get("dropout", 0.0))
    cnoise = float(sensor.get("color_noise", 0.0))
    max_depth = float(sensor.get("max_depth_m", 10.0))
    if max_depth * cam.depth_factor > np.iinfo(np.uint16).max:
        raise ValueError(f"max_depth_m {max_depth} x depth factor {cam.depth_factor} "
                         "overflows uint16 depth")
    for b0 in range(0, n, batch):
        b1 = min(n, b0 + batch)
        T = torch.as_tensor(poses[b0:b1], dtype=torch.float32, device=device)
        R_wc = T[:, :3, :3].transpose(1, 2)
        C = -(R_wc @ T[:, :3, 3:4])[..., 0]  # [B, 3]
        dirs = torch.einsum("bij,pj->bpi", R_wc, d_cam).reshape(-1, 3)
        orig = C[:, None, :].expand(-1, d_cam.shape[0], -1).reshape(-1, 3)
        t, rgb = cast(scene, orig, dirs)
        z = t.reshape(b1 - b0, H, W)
        rgb = rgb.reshape(b1 - b0, H, W, 3)
        if gray:
            rgb = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        if kind == "kinect":
            sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
            z = z + sigma * torch.randn(z.shape, generator=gen, device=device)
        if dropout > 0:
            z = torch.where(torch.rand(z.shape, generator=gen, device=device) < dropout,
                            torch.zeros_like(z), z)
        z = torch.where(torch.isfinite(z) & (z > 0.0) & (z < max_depth), z, torch.zeros_like(z))
        if cnoise > 0:
            rgb = rgb + cnoise * torch.randn(rgb.shape, generator=gen, device=device)
        depths[b0:b1] = torch.round(z * cam.depth_factor).to(torch.int32).cpu().numpy()
        colors[b0:b1] = torch.round(rgb.clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()
    return colors, depths


def make_sequence(scene: Scene, cam: CameraModel, traffic: dict, seed: int,
                  device: torch.device, sensor: str = "rgbd") -> Sequence:
    poses = trajectory(traffic, seed, device)
    colors, depths = render_frames(scene, cam, poses, traffic["sensor"], seed, device)
    rights = None
    if sensor == "stereo":
        # The right camera's centre lies +b along the left camera's x axis:
        # the same rotation, the translation less b along x.
        right = poses.copy()
        right[:, 0, 3] -= cam.bf / cam.fx  # the baseline b = bf / fx
        noise = {k: v for k, v in traffic["sensor"].items() if k in ("color_noise", "gray",
                                                                     "max_depth_m")}
        rights, _ = render_frames(scene, cam, right, noise, seed, device, salt=RIGHT_SALT)
    ts = np.arange(poses.shape[0], dtype=np.float64) / cam.fps
    return Sequence(colors=colors, depths=depths, T_cw=poses, timestamps=ts,
                    depth_factor=cam.depth_factor, rights=rights)


def _unit_rgb(im: np.ndarray) -> np.ndarray:
    rgb = im.astype(np.float32) / 255.0
    return np.repeat(rgb[..., None], 3, axis=-1) if rgb.ndim == 2 else rgb


def frame_tensors(seq: Sequence, i: int, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame ``i`` as the loaders hand it to ``track_rgbd``: colour in
    [0, 1] (gray replicated to three channels) and depth in metres, float32
    on the device (upload and conversion included, as a user's loader pays
    them)."""
    c = torch.from_numpy(seq.colors[i]).to(device, non_blocking=False)
    if c.ndim == 2:
        c = c[..., None].expand(-1, -1, 3)
    d = torch.from_numpy(seq.depths[i].astype(np.int32)).to(device)
    return c.to(torch.float32) / 255.0, d.to(torch.float32) / seq.depth_factor


def stereo_pair(seq: Sequence, i: int) -> tuple[np.ndarray, np.ndarray]:
    """Frame ``i``'s pair as ``KittiStereoDataset`` hands it to
    ``track_stereo``: float32 numpy ``[H, W, 3]`` in [0, 1], gray
    replicated to three channels."""
    return _unit_rgb(seq.colors[i]), _unit_rgb(seq.rights[i])
