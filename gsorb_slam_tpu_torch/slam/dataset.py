"""Datasets: the TUM, Replica and ScanNet RGB-D disk layouts and their
exporters, the generated sequences, and the monocular (TUM ``rgb.txt``,
KITTI ``image_0``) and stereo (KITTI, generated pairs) sequences
(counterpart of ``gsorb_slam_tpu/slam/dataset.py``).

Every RGB-D dataset yields :class:`RGBDFrame` ``(timestamp, rgb [H, W, 3]
f32 in [0, 1], depth [H, W] f32 meters)`` with the ground-truth pose where
there is one; the monocular ones yield :class:`MonoFrame` and the stereo
ones :class:`StereoFrame` (rectified left and right images). Frames are
host numpy arrays; the System moves them to its device.

Images on disk (PNG color and 16-bit depth, JPEG color) are read and
written through ``cv2``, else Pillow, the JAX package's order; where
neither imports, reading or writing an image raises. The exporters write
JPEG at quality 98.

Both generators are made from a numpy seed and render their frames with the
port's :func:`~gsorb_slam_tpu_torch.raster.render` on ``device`` (K3 on the
card), with the JAX package's raster configuration; the numpy draws follow
the JAX package's order, so the same seed gives the same scene, trajectory
and noise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.camera import Camera, Distortion, undistort_points
from gsorb_slam_tpu_torch.raster import RasterConfig, render


def _image_codec() -> str:
    """``"cv2"`` or ``"pillow"``: the image codec this machine has, in the
    JAX package's order of preference."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        import PIL.Image  # noqa: F401

        return "pillow"
    except ImportError:
        pass
    raise RuntimeError("reading or writing images needs cv2 or Pillow, and neither is installed")


def image_codec_name() -> str | None:
    """The codec the image readers and writers use, or None without one."""
    try:
        return _image_codec()
    except RuntimeError:
        return None


def _imread_color(path: str) -> np.ndarray:
    """8-bit color image -> RGB float32 in [0, 1]."""
    if _image_codec() == "cv2":
        import cv2

        im = cv2.imread(path, cv2.IMREAD_COLOR)
        if im is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(im, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _imread_depth(path: str, factor: float) -> np.ndarray:
    """Depth image (16-bit) -> float32 meters (raw value / ``factor``)."""
    if _image_codec() == "cv2":
        import cv2

        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            d = np.asarray(im)
    return d.astype(np.float32) / factor


def _imwrite(path: str, img: np.ndarray, jpeg_quality: int | None = None) -> None:
    """Write 8-bit RGB ``[H, W, 3]`` or 16-bit gray ``[H, W]``."""
    if _image_codec() == "cv2":
        import cv2

        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        params = [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality] if jpeg_quality else []
        if not cv2.imwrite(path, img, params):
            raise OSError(f"cv2 could not write {path}")
        return
    from PIL import Image

    Image.fromarray(img).save(path, **({"quality": jpeg_quality} if jpeg_quality else {}))


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


def associate_timestamps(
    a: np.ndarray, b: np.ndarray, max_dt: float = 0.02
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (``scripts/associate.py``): each
    ``a[i]`` in turn takes its nearest ``b[j]`` if that is within ``max_dt``
    and not taken yet."""
    pairs = []
    used_b: set[int] = set()
    for i, ta in enumerate(a):
        j = int(np.argmin(np.abs(b - ta)))
        if abs(b[j] - ta) < max_dt and j not in used_b:
            pairs.append((i, j))
            used_b.add(j)
    return pairs


def _read_rows(path: str) -> list[list[str]]:
    """The fields of each line of a TUM list file, without comments."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append(line.split())
    return rows


class TUMDataset(RGBDDataset):
    """TUM RGB-D: ``rgb.txt`` / ``depth.txt`` associated by timestamp,
    DepthMapFactor 5000 (``src/Tracking.cc:275-276``), an optional
    ``groundtruth.txt`` (``t x y z qx qy qz qw`` of T_wc)."""

    def __init__(self, root: str, depth_factor: float = 5000.0, max_dt: float = 0.02):
        self.root = root
        self.depth_factor = depth_factor

        def read_list(name):
            rows = _read_rows(os.path.join(root, name))
            return np.array([float(r[0]) for r in rows]), [r[1] for r in rows]

        rgb_ts, rgb_files = read_list("rgb.txt")
        d_ts, d_files = read_list("depth.txt")
        pairs = associate_timestamps(rgb_ts, d_ts, max_dt)
        self.items = [
            (rgb_ts[i], os.path.join(root, rgb_files[i]), os.path.join(root, d_files[j]))
            for i, j in pairs
        ]
        self.gt = self._load_gt(os.path.join(root, "groundtruth.txt"))

    @staticmethod
    def _load_gt(path: str) -> Optional[np.ndarray]:
        if not os.path.exists(path):
            return None
        return np.array([[float(x) for x in r] for r in _read_rows(path)])  # [N, 8]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        t, rgb_p, d_p = self.items[i]
        return RGBDFrame(timestamp=t, rgb=_imread_color(rgb_p),
                         depth=_imread_depth(d_p, self.depth_factor), gt_T_cw=self._gt_pose(t))

    def _gt_pose(self, t: float) -> Optional[np.ndarray]:
        """The ground-truth T_cw nearest ``t``, if one lies within 50 ms."""
        if self.gt is None:
            return None
        j = int(np.argmin(np.abs(self.gt[:, 0] - t)))
        if abs(self.gt[j, 0] - t) > 0.05:
            return None
        x, y, z, qx, qy, qz, qw = self.gt[j, 1:8]
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = _quat_to_R(qw, qx, qy, qz)
        T_wc[:3, 3] = [x, y, z]
        return np.linalg.inv(T_wc).astype(np.float32)


class ReplicaDataset(RGBDDataset):
    """Replica (the iMAP / NICE-SLAM export): ``results/frame%06d.jpg`` and
    ``depth%06d.png`` (scale 6553.5), ``traj.txt`` with one row-major T_wc
    per line."""

    def __init__(self, root: str, depth_factor: float = 6553.5):
        self.root = root
        self.depth_factor = depth_factor
        res = os.path.join(root, "results")
        self.n = len([f for f in os.listdir(res) if f.startswith("frame")])
        traj_path = os.path.join(root, "traj.txt")
        self.traj = (np.loadtxt(traj_path).reshape(-1, 4, 4).astype(np.float32)
                     if os.path.exists(traj_path) else None)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rgb = _imread_color(os.path.join(self.root, "results", f"frame{i:06d}.jpg"))
        depth = _imread_depth(os.path.join(self.root, "results", f"depth{i:06d}.png"),
                              self.depth_factor)
        gt = None
        if self.traj is not None:
            gt = np.linalg.inv(self.traj[i]).astype(np.float32)  # the file holds T_wc
        return RGBDFrame(timestamp=float(i), rgb=rgb, depth=depth, gt_T_cw=gt)


class ScanNetDataset(RGBDDataset):
    """ScanNet exported scans: ``color/%d.jpg``, ``depth/%d.png``
    (millimeters), ``pose/%d.txt`` T_wc (a non-finite pose: no ground
    truth for that frame)."""

    def __init__(self, root: str, depth_factor: float = 1000.0):
        self.root = root
        self.depth_factor = depth_factor
        self.n = len(os.listdir(os.path.join(root, "depth")))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rgb = _imread_color(os.path.join(self.root, "color", f"{i}.jpg"))
        depth = _imread_depth(os.path.join(self.root, "depth", f"{i}.png"), self.depth_factor)
        pose_p = os.path.join(self.root, "pose", f"{i}.txt")
        gt = None
        if os.path.exists(pose_p):
            T_wc = np.loadtxt(pose_p).astype(np.float32)
            if np.all(np.isfinite(T_wc)):
                gt = np.linalg.inv(T_wc).astype(np.float32)
        return RGBDFrame(timestamp=float(i), rgb=rgb, depth=depth, gt_T_cw=gt)


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

    ``apply_distortion=True`` warps TUM1's Brown-Conrady distortion into
    the images (``I_observed(x) = I_ideal(undistort(x))``, bilinear for the
    color and nearest for the depth, through ``cv2.remap`` with a zero
    border, as the JAX package does).

    ``cache_dir`` keeps the frames in a ``.npz`` there and reloads them on
    the next call with the same arguments. Its name (``tumlike_torch_...``)
    differs from the JAX package's cache: the two packages render
    different floats, and may share the directory."""

    # TUM1 calibration (Examples/RGB-D/tum/TUM1.yaml)
    FX, FY, CX, CY = 517.306408, 516.469215, 318.643040, 255.313989
    DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)

    def __init__(
        self,
        n_frames: int = 100,
        seed: int = 0,
        width: int = 640,
        height: int = 480,
        apply_distortion: bool = True,
        noise: bool = True,
        splat_spacing: float = 0.02,
        cache_dir: Optional[str] = None,
        device: torch.device | str = "cuda",
    ):
        s = width / 640.0
        self.cam = Camera(fx=self.FX * s, fy=self.FY * s, cx=self.CX * s, cy=self.CY * s,
                          width=width, height=height)
        rng = np.random.default_rng(seed)

        cache = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache = os.path.join(
                cache_dir,
                f"tumlike_torch_{n_frames}_{seed}_{width}x{height}_{int(apply_distortion)}"
                f"_{int(noise)}_{splat_spacing:g}.npz",
            )
            if os.path.exists(cache):
                with np.load(cache) as z:
                    self.frames = list(zip(z["rgb"], z["depth"]))
                    self.poses = list(z["poses"])
                return

        means, rgb = self._build_room(rng, splat_spacing)
        n = len(means)
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        logit_op = np.full(n, 7.0, np.float32)
        log_scales = np.log(np.full((n, 3), splat_spacing * 0.9, np.float32))
        rcfg = RasterConfig(tile=16, tile_capacity=2048, max_dup=16, chunk=256, dilate_px=2.0)
        rfn = _renderer(means, rgb, quats, logit_op, log_scales, self.cam, rcfg, device)
        maps = self._undistort_maps() if apply_distortion else None

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
            if maps is not None:
                import cv2

                color = cv2.remap(color, maps[0], maps[1], cv2.INTER_LINEAR,
                                  borderMode=cv2.BORDER_CONSTANT)
                depth = cv2.remap(depth, maps[0], maps[1], cv2.INTER_NEAREST,
                                  borderMode=cv2.BORDER_CONSTANT)
            if noise:
                sig = 0.0012 + 0.0019 * np.square(np.maximum(depth - 0.4, 0.0))
                depth = depth + rng.normal(0, 1, depth.shape) * sig
                depth = np.round(depth * 5000.0) / 5000.0  # sensor quantization
                drop = rng.uniform(size=depth.shape) < 0.01
                depth = np.where(drop | (depth <= 0.05), 0.0, depth)
                color = np.clip(color + rng.normal(0, 0.008, color.shape), 0, 1).astype(np.float32)
            self.frames.append((color.astype(np.float32), depth.astype(np.float32)))
            self.poses.append(T_cw)
        if cache:
            np.savez_compressed(cache, rgb=np.stack([f[0] for f in self.frames]),
                                depth=np.stack([f[1] for f in self.frames]),
                                poses=np.stack(self.poses))

    def _undistort_maps(self) -> tuple[np.ndarray, np.ndarray]:
        """``cv2.remap`` maps with ``I_observed(x) = I_ideal(undistort(x))``."""
        H, W = self.cam.height, self.cam.width
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        grid = torch.as_tensor(np.stack([uu.ravel(), vv.ravel()], -1))
        und = undistort_points(self.cam, Distortion(*self.DIST), grid).numpy()
        return (und[:, 0].reshape(H, W).astype(np.float32),
                und[:, 1].reshape(H, W).astype(np.float32))

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


def open_dataset(kind: str, path: str, depth_factor: float) -> RGBDDataset:
    """The disk dataset of ``kind`` (tum, replica or scannet) at ``path``. The
    TUM default factor 5000 means each layout's own default (Replica
    6553.5, ScanNet 1000)."""
    kind = kind.lower()
    if kind == "tum":
        return TUMDataset(path, depth_factor)
    if kind == "replica":
        return ReplicaDataset(path, depth_factor if depth_factor != 5000.0 else 6553.5)
    if kind == "scannet":
        return ScanNetDataset(path, depth_factor if depth_factor != 5000.0 else 1000.0)
    raise ValueError(f"unknown dataset type: {kind}")



# Monocular and stereo sequences (the reference's Examples/Monocular and
# Examples/Stereo loaders).


@dataclasses.dataclass
class MonoFrame:
    timestamp: float
    rgb: np.ndarray  # [H, W, 3] float32 in [0, 1]
    gt_T_cw: Optional[np.ndarray] = None


@dataclasses.dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray  # [H, W, 3] float32 in [0, 1]
    right: np.ndarray  # [H, W, 3] float32 in [0, 1]
    gt_T_cw: Optional[np.ndarray] = None


class MonoTumDataset:
    """Monocular TUM sequence: ``rgb.txt`` only, no depth association
    (``Examples/Monocular/mono_tum.cc`` LoadImages); ``groundtruth.txt`` is
    optional, for evaluation."""

    def __init__(self, root: str):
        self.root = root
        self.items = [(float(r[0]), os.path.join(root, r[1]))
                      for r in _read_rows(os.path.join(root, "rgb.txt"))]
        self.gt = TUMDataset._load_gt(os.path.join(root, "groundtruth.txt"))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i) -> MonoFrame:
        t, p = self.items[i]
        return MonoFrame(timestamp=t, rgb=_imread_color(p), gt_T_cw=TUMDataset._gt_pose(self, t))


class KittiStereoDataset:
    """KITTI odometry stereo: ``image_0/`` (left gray), ``image_1/`` (right
    gray), ``times.txt`` (``Examples/Stereo/stereo_kitti.cc`` LoadImages).
    With ``mono=True`` only ``image_0`` is read (``mono_kitti.cc``)."""

    def __init__(self, root: str, mono: bool = False):
        self.root = root
        self.mono = mono
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split() if x.strip()]
        names = sorted(os.listdir(os.path.join(root, "image_0")))
        n = min(len(self.times), len(names))
        self.times = self.times[:n]
        self.left = [os.path.join(root, "image_0", name) for name in names[:n]]
        self.right = None if mono else [os.path.join(root, "image_1", name)
                                        for name in names[:n]]

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i):
        if self.mono:
            return MonoFrame(timestamp=self.times[i], rgb=_imread_color(self.left[i]))
        return StereoFrame(timestamp=self.times[i], left=_imread_color(self.left[i]),
                           right=_imread_color(self.right[i]))


class StereoSyntheticDataset:
    """Rectified stereo pairs rendered from one :class:`SyntheticDataset`
    scene: the right camera is the left pose shifted by ``baseline`` along
    camera +x (x_right = x_left - b); the seed shares the scene."""

    def __init__(self, cam: Camera, baseline: float, n_frames: int = 10,
                 device: torch.device | str = "cuda", **kw):
        left = SyntheticDataset(cam, n_frames=n_frames, device=device, **kw)
        T_b = np.eye(4, dtype=np.float32)
        T_b[0, 3] = -baseline
        right = SyntheticDataset(cam, trajectory=[T_b @ T for T in left.poses], device=device,
                                 **kw)
        self.cam = cam
        self._left, self._right = left, right

    def __len__(self):
        return len(self._left)

    def __getitem__(self, i) -> StereoFrame:
        lf, rf = self._left[i], self._right[i]
        return StereoFrame(timestamp=lf.timestamp, left=lf.rgb, right=rf.rgb,
                           gt_T_cw=lf.gt_T_cw)


def _rgb8(rgb: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)


def _depth16(depth: np.ndarray, factor: float) -> np.ndarray:
    # Truncating, as the JAX package's exporters: the same files on both sides.
    return np.clip(np.asarray(depth) * factor, 0, 65535).astype(np.uint16)


def _T_wc(fr: RGBDFrame) -> np.ndarray:
    return np.linalg.inv(fr.gt_T_cw) if fr.gt_T_cw is not None else np.eye(4, dtype=np.float32)


def export_tum_format(
    ds, root: str, fps: float = 30.0, t0: float = 1305031102.0,
    jitter_ms: float = 4.0, seed: int = 0,
) -> None:
    """Write an RGB-D dataset in the TUM sequence layout: ``rgb/*.png``
    (8-bit), ``depth/*.png`` (16-bit, meters x 5000), ``rgb.txt`` /
    ``depth.txt`` with independently jittered timestamps (so the
    association is exercised, as in ``scripts/associate.py``) and
    ``groundtruth.txt`` (``t x y z qx qy qz qw`` of T_wc)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    d_lines = ["# depth images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(len(ds)):
        fr = ds[i]
        t_rgb = t0 + i / fps + rng.uniform(-jitter_ms, jitter_ms) * 1e-3
        t_d = t0 + i / fps + rng.uniform(-jitter_ms, jitter_ms) * 1e-3
        rgb_name = f"rgb/{t_rgb:.6f}.png"
        d_name = f"depth/{t_d:.6f}.png"
        _imwrite(os.path.join(root, rgb_name), _rgb8(fr.rgb))
        _imwrite(os.path.join(root, d_name), _depth16(fr.depth, 5000.0))
        rgb_lines.append(f"{t_rgb:.6f} {rgb_name}")
        d_lines.append(f"{t_d:.6f} {d_name}")
        if fr.gt_T_cw is not None:
            T_wc = np.linalg.inv(fr.gt_T_cw)
            tx, ty, tz = T_wc[:3, 3]
            qw, qx, qy, qz = _R_to_quat(T_wc[:3, :3])
            gt_lines.append(f"{t_rgb:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(d_lines) + "\n")
    if len(gt_lines) > 2:
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("\n".join(gt_lines) + "\n")


def export_replica_format(ds, root: str) -> None:
    """Write an RGB-D dataset in the Replica (iMAP / NICE-SLAM export)
    layout that :class:`ReplicaDataset` reads: ``results/frame%06d.jpg``
    (JPEG, quality 98), ``results/depth%06d.png`` (16-bit, meters x 6553.5)
    and ``traj.txt``, one row-major T_wc per line."""
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    traj = []
    for i in range(len(ds)):
        fr = ds[i]
        _imwrite(os.path.join(root, "results", f"frame{i:06d}.jpg"), _rgb8(fr.rgb), 98)
        _imwrite(os.path.join(root, "results", f"depth{i:06d}.png"), _depth16(fr.depth, 6553.5))
        traj.append(" ".join(f"{v:.9f}" for v in _T_wc(fr).reshape(-1)))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(traj) + "\n")


def export_scannet_format(ds, root: str) -> None:
    """Write an RGB-D dataset in the exported-ScanNet layout that
    :class:`ScanNetDataset` reads: ``color/%d.jpg`` (JPEG, quality 98),
    ``depth/%d.png`` (16-bit millimeters) and ``pose/%d.txt`` (4x4 T_wc)."""
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(len(ds)):
        fr = ds[i]
        _imwrite(os.path.join(root, "color", f"{i}.jpg"), _rgb8(fr.rgb), 98)
        _imwrite(os.path.join(root, "depth", f"{i}.png"), _depth16(fr.depth, 1000.0))
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"), _T_wc(fr), fmt="%.9f")


def _R_to_quat(R: np.ndarray):
    """Rotation matrix -> (w, x, y, z)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return float(w), float(x), float(y), float(z)
