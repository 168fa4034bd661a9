"""The benchmark's own inputs: the scene ray-caster, the path, the sensor
and the distortion warp, on the CPU at tiny sizes."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench.lib.evaluate import camera_centres
from slambench.lib.scene import Box, Scene, cast, load_scene
from slambench.lib.sequence import (
    CameraModel,
    look_at,
    make_sequence,
    trajectory,
    undistort_pixels,
)

SB = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def tiny_camera(dist=(0.0,) * 5) -> CameraModel:
    return CameraModel(width=40, height=30, fx=40.0, fy=40.0, cx=19.5, cy=14.5, dist=dist,
                       depth_factor=5000.0, fps=30.0)


def traffic(**kw) -> dict:
    t = json.loads((SB / "traffic" / "desk.json").read_text())
    t["n_frames"] = 6
    t.update(kw)
    return t


def test_sequence_is_a_function_of_the_seed():
    scene = load_scene(SB / "scenes" / "desk_room.json")
    a = make_sequence(scene, tiny_camera(), traffic(), 2**31 + 7, CPU)
    b = make_sequence(scene, tiny_camera(), traffic(), 2**31 + 7, CPU)
    c = make_sequence(scene, tiny_camera(), traffic(), 2**31 + 8, CPU)
    assert np.array_equal(a.colors, b.colors) and np.array_equal(a.depths, b.depths)
    assert np.array_equal(a.T_cw, b.T_cw)
    assert not np.array_equal(a.depths, c.depths)
    assert a.colors.dtype == np.uint8 and a.depths.dtype == np.uint16


def test_path_moves_step_mm_a_frame_without_shake():
    t = traffic(shake={"trans_mm": 0.0, "rot_deg": 0.0, "smooth_frames": 3})
    t["path"] = dict(t["path"], look_sway_m=0.0)
    poses = trajectory(t, 1, CPU)
    c = camera_centres(poses)
    r = t["path"]["radius_m"]
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    theta = t["path"]["step_mm"] / 1000.0 / r
    assert np.allclose(step, 2 * r * math.sin(theta / 2), rtol=1e-9)
    # Rotation a frame: the orbit's yaw rate.
    R0, R1 = poses[0][:3, :3], poses[1][:3, :3]
    ang = math.acos(np.clip((np.trace(R1 @ R0.T) - 1) / 2, -1, 1))
    assert math.isclose(ang, theta, rel_tol=1e-6)


def test_shake_has_the_stated_spread():
    t = traffic(n_frames=400)
    base = trajectory(dict(t, shake={"trans_mm": 0.0, "rot_deg": 0.0, "smooth_frames": 6}), 3, CPU)
    shaken = trajectory(t, 3, CPU)
    # The shake is a camera-frame motion D with shaken = D @ base.
    D = shaken @ np.linalg.inv(base)
    assert np.allclose((D[:, :3, 3] * 1000.0).std(axis=0, ddof=1), t["shake"]["trans_mm"], rtol=1e-6)
    ang = np.degrees(np.arccos(np.clip((np.trace(D[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)))
    # Three axes of standard deviation rot_deg: the angle's RMS is sqrt(3) of it.
    assert math.isclose(float(np.sqrt((ang ** 2).mean())), math.sqrt(3) * t["shake"]["rot_deg"],
                        rel_tol=0.05)


def test_ray_cast_depth_is_camera_z():
    # A camera at the origin looking down +x at a wall at x = 2.
    scene = Scene("wall", (Box(lo=(2.0, -5, -5), hi=(3.0, 5, 5), inside=False,
                              color=(1.0, 1.0, 1.0), cell=0.1, fine_cell=0.02, contrast=0.5),))
    T = look_at(np.zeros(3), np.array([1.0, 0.0, 0.0]))
    R_wc = torch.as_tensor(T[:3, :3].T, dtype=torch.float32)
    d_cam = torch.tensor([[0.0, 0.0, 1.0], [0.3, -0.2, 1.0]])
    t, rgb = cast(scene, torch.zeros((2, 3)), d_cam @ R_wc.T)
    assert torch.allclose(t, torch.full((2,), 2.0), atol=1e-5)
    assert bool((rgb > 0).all())


def distort(cam: CameraModel, u: np.ndarray, v: np.ndarray):
    k1, k2, p1, p2, k3 = cam.dist
    x, y = (u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return cam.fx * xd + cam.cx, cam.fy * yd + cam.cy


def test_undistort_inverts_brown_conrady_inside_the_image():
    cam = CameraModel(width=640, height=480, fx=517.306408, fy=516.469215, cx=318.643040,
                      cy=255.313989, dist=(0.262383, -0.953104, -0.005358, 0.002628, 1.163314),
                      depth_factor=5000.0, fps=30.0)
    vv, uu = np.meshgrid(np.arange(80, 400, 40.0), np.arange(80, 560, 40.0), indexing="ij")
    ui, vi = undistort_pixels(cam, torch.as_tensor(uu), torch.as_tensor(vv))
    ud, vd = distort(cam, ui.numpy(), vi.numpy())
    assert np.abs(ud - uu).max() < 0.05 and np.abs(vd - vv).max() < 0.05


@pytest.mark.parametrize("cell_traffic", ["desk", "room0", "flat"])
def test_traffic_files_name_a_scene(cell_traffic):
    t = json.loads((SB / "traffic" / f"{cell_traffic}.json").read_text())
    assert (SB / "scenes" / f"{t['scene']}.json").is_file()
    assert t["warmup_frames"] < t["eval_frames"] <= t["n_frames"]
    assert t["eval_frames"] % 4 == 0
