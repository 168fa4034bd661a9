"""The port's viewers and drawing against the JAX package's, on the CPU.

- Every function of ``utils/drawing.py`` byte for byte (``uint8`` images,
  ``camera_centers`` and ``_frustum_world`` exactly) against the JAX
  module's.
- ``apps.viewer`` in ``orbit`` and ``replay`` mode on a small PLY (64x48):
  the JAX viewer's PNG names, and their pixels within one 8-bit level on at
  least 99% of them (the two renders differ by rounding).
- ``apps.viewer_web``: ``orbit_pose`` equal to the JAX function's within
  1e-6; an HTTP round trip on an ephemeral port (the page, the state, one
  ``splat`` and one ``map`` render, the render called at the orbit pose);
  ``ViewerServer.from_system`` over the port's ``System`` after one frame,
  both modes decoding to the camera's size, its centre equal to the map's
  (the JAX package's tests of the same, ``tests/test_apps.py:129-262``, are
  marked slow there).
"""

import json
import os
import threading
import urllib.request
from http.server import HTTPServer

import cv2
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.apps import viewer as j_viewer
from gsorb_slam_tpu.apps import viewer_web as j_viewer_web
from gsorb_slam_tpu.utils import drawing as JD
from gsorb_slam_tpu_torch.apps import viewer, viewer_web
from gsorb_slam_tpu_torch.core.config import CameraConfig, MappingConfig, SystemConfig
from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.eval.ply import save_gaussian_ply
from gsorb_slam_tpu_torch.eval.trajectory import save_tum
from gsorb_slam_tpu_torch.slam.system import System
from gsorb_slam_tpu_torch.utils import drawing as D

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)


def _poses(rng, n):
    out = []
    for _ in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(T[:3, :3]) < 0:
            T[:3, 0] *= -1
        T[:3, 3] = rng.normal(0, 0.3, 3)
        out.append(T)
    return out


def test_drawing_matches_jax(rng):
    rgb = rng.uniform(-0.1, 1.1, (48, 64, 3)).astype(np.float32)
    uv = rng.uniform(-5, 70, (40, 2)).astype(np.float32)
    valid, matched = rng.uniform(size=40) < 0.8, rng.uniform(size=40) < 0.5
    for kw in ({}, dict(valid=valid), dict(valid=valid, matched=matched, radius=3)):
        a, b = D.draw_keypoints(rgb, uv, **kw), JD.draw_keypoints(rgb, uv, **kw)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    means = rng.normal(0, 1, (500, 3)).astype(np.float32)
    active = rng.uniform(size=500) < 0.7
    kfs = _poses(rng, 5)
    centers = D.camera_centers(kfs)
    np.testing.assert_array_equal(centers, JD.camera_centers(kfs))
    np.testing.assert_array_equal(D.camera_centers([]), JD.camera_centers([]))
    traj = rng.normal(0, 0.5, (20, 3)).astype(np.float32)
    for kw in ({}, dict(active=active, kf_positions=centers, trajectory=traj, size=128),
               dict(active=np.zeros(500, bool)), dict(axes=(0, 1), size=64)):
        np.testing.assert_array_equal(D.draw_map_topdown(means, **kw),
                                      JD.draw_map_topdown(means, **kw))
    img_a, img_b = np.zeros((30, 40, 3), np.uint8), np.zeros((30, 40, 3), np.uint8)
    for p0, p1 in (((-3.0, 2.0), (50.0, 25.0)), ((5.5, 5.5), (5.5, 5.5))):
        D._draw_segment(img_a, p0, p1, (1, 2, 3))
        JD._draw_segment(img_b, p0, p1, (1, 2, 3))
    np.testing.assert_array_equal(img_a, img_b)
    np.testing.assert_array_equal(D._frustum_world(kfs[0], 0.07), JD._frustum_world(kfs[0], 0.07))
    pts = np.stack([rng.uniform(-1, 1, 3000), rng.uniform(-1, 1, 3000),
                    rng.uniform(0.5, 3, 3000)], -1).astype(np.float32)
    near = [np.eye(4, dtype=np.float32)] + [np.eye(4, dtype=np.float32) for _ in range(2)]
    near[1][0, 3], near[2][1, 3] = -0.3, 0.2
    for kw in (dict(kf_T_cw=near, graph_edges=[(0, 1), (1, 2), (0, 5)], cur_T_cw=near[2],
                    trajectory=traj * 0.2 + np.array([0, 0, 1.5], np.float32)),
               dict(active=rng.uniform(size=3000) < 0.5, max_points=700, focal=50.0,
                    frustum_scale=0.1),
               dict(active=np.zeros(3000, bool))):
        a = D.draw_map_3d(pts, np.eye(4, dtype=np.float32), 96, 72, **kw)
        np.testing.assert_array_equal(a, JD.draw_map_3d(pts, np.eye(4, dtype=np.float32), 96, 72,
                                                        **kw))
        assert a.shape == (72, 96, 3)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A PLY of 1,500 random splats in front of the origin, a 64x48 camera
    as ``.json`` and a 3-pose TUM trajectory."""
    root = tmp_path_factory.mktemp("viewer")
    rng = np.random.default_rng(5)
    n = 1500
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(1.5, 3.0, n)], -1).astype(np.float32)
    save_gaussian_ply(str(root / "map.ply"), means, rng.uniform(0.1, 1, (n, 3)),
                      np.full(n, 3.0, np.float32),
                      np.log(rng.uniform(0.03, 0.08, (n, 3))).astype(np.float32),
                      rng.normal(size=(n, 4)).astype(np.float32))
    traj = []
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.05 * i
        traj.append((float(i), T))
    save_tum(str(root / "traj.txt"), traj)
    with open(root / "cfg.json", "w") as f:
        json.dump({"Camera": {**CAM_KW, "fps": 30.0}}, f)
    return root


@pytest.mark.parametrize("mode", ["orbit", "replay"])
def test_viewer_matches_jax(scene, tmp_path, mode):
    argv = ["--ply", str(scene / "map.ply"), "--config", str(scene / "cfg.json"), "--mode", mode,
            "--traj", str(scene / "traj.txt"), "--frames", "4", "--radius", "0.3"]
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    assert viewer.main(argv + ["--out", str(mine), "--cpu"]) == 0
    assert j_viewer.main(argv + ["--out", str(theirs)]) == 0
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    assert names == [f"view_{i:04d}.png" for i in range(4 if mode == "orbit" else 3)]
    for name in names:
        a = cv2.imread(str(mine / name)).astype(np.int64)
        b = cv2.imread(str(theirs / name)).astype(np.int64)
        assert a.shape == b.shape == (48, 64, 3)
        assert (np.abs(a - b) <= 1).all(-1).mean() >= 0.99, name
        assert a.std() > 5  # the splats are in view


def test_orbit_pose_matches_jax():
    for args in [((1.0, -0.5, 3.0), 0.0, 0.0, 1.7, 0.0, 0.0), ((0.0, 0.0, 2.0), 1.0, 0.3, 2.0,
                                                             0.1, -0.2),
                 ((0.2, 0.1, 1.0), -2.0, -0.5, 0.8, 0.0, 0.3), ((0, 0, 0), 0.0, 1.5707963, 1.0,
                                                              0.0, 0.0)]:
        c = np.array(args[0])
        np.testing.assert_allclose(viewer_web.orbit_pose(c, *args[1:]),
                                   j_viewer_web.orbit_pose(c, *args[1:]), rtol=0, atol=1e-6)
        T = viewer_web.orbit_pose(c, *args[1:4])
        np.testing.assert_allclose(T[:3, :3] @ c + T[:3, 3], [0, 0, args[3]], atol=1e-5)


class _Served:
    """``srv`` on 127.0.0.1 at an ephemeral port, in a thread."""

    def __init__(self, srv):
        self.httpd = HTTPServer(("127.0.0.1", 0), srv.handler())
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def get(self, path):
        return urllib.request.urlopen(self.url + path, timeout=30).read()

    def render(self, state):
        req = urllib.request.Request(self.url + "/render", data=json.dumps(state).encode(),
                                     method="POST")
        return urllib.request.urlopen(req, timeout=60).read()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _decode(buf):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


def test_viewer_web_round_trip():
    H, W = 48, 64
    calls = []

    def render_fn(T_cw):
        calls.append(np.asarray(T_cw))
        img = np.zeros((H, W, 3), np.float32)
        img[:, :, 0] = 0.5
        return img

    pts = np.stack([np.linspace(-0.5, 0.5, 200), np.zeros(200), np.full(200, 2.0)], -1)
    srv = viewer_web.ViewerServer(render_fn, W, H, center=np.array([0.0, 0.0, 2.0]), dist0=2.0,
                                  map_state_fn=lambda: dict(points=pts))
    served = _Served(srv)
    try:
        assert b"orbit" in served.get("/")
        state = json.loads(served.get("/state"))
        assert state["width"] == W and state["dist"] == 2.0 and state["mode"] == "splat"
        state["yaw"] = 0.4
        img = _decode(served.render(state))
        assert img.shape == (H, W, 3) and abs(int(img[..., 2].mean()) - 127) <= 2
        assert len(calls) == 1
        T = calls[0]
        np.testing.assert_allclose(T[:3, :3] @ [0.0, 0.0, 2.0] + T[:3, 3], [0, 0, 2.0],
                                   atol=1e-5)
        np.testing.assert_array_equal(T, j_viewer_web.orbit_pose(np.array([0.0, 0.0, 2.0]), 0.4,
                                                                 0.0, 2.0))
        state["mode"] = "map"
        img = _decode(served.render(state))
        assert img.shape == (H, W, 3) and len(calls) == 1
        with pytest.raises(urllib.error.HTTPError):
            served.get("/nothing")
    finally:
        served.close()


def test_viewer_web_from_system():
    cfg = SystemConfig(camera=CameraConfig(**CAM_KW, fps=30),
                       mapping=MappingConfig(num_iters=2, init_iters=2, max_gaussians=1 << 12),
                       tracking=TrackingConfig(num_iters=2))
    s = System(cfg, max_keyframes=4, frontend="render", device="cpu")
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    s.track_rgbd(rgb, np.full((48, 64), 1.5, np.float32), 0.0)
    srv = viewer_web.ViewerServer.from_system(s)
    assert srv.map_state_fn is not None
    pts = s.gm.means[s.gm.active].numpy()
    np.testing.assert_allclose(srv.center, pts.mean(0), atol=1e-5)
    assert srv.state0["dist0"] == pytest.approx(
        float(np.linalg.norm(pts - pts.mean(0), axis=1).mean()) * 2.0, rel=1e-5)
    ms = srv.map_state_fn()
    assert len(ms["kf_T_cw"]) == 1 and ms["trajectory"].shape == (1, 3)
    served = _Served(srv)
    try:
        state = json.loads(served.get("/state"))
        for mode in ("splat", "map"):
            state["mode"] = mode
            img = _decode(served.render(state))
            assert img.shape == (48, 64, 3)
            assert img.std() > 1, mode
    finally:
        served.close()
    half = viewer_web.ViewerServer.from_system(s, scale=0.5)
    assert (half.state0["width"], half.state0["height"]) == (32, 24)
    assert half.render_fn(np.eye(4, dtype=np.float32)).shape == (24, 32, 3)
