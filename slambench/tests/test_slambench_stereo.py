"""The stereo entry point in the harness, on the CPU at tiny sizes: the
generator's right view and travel heading, a whole stereo run through
``System.track_stereo`` judged correct, the dropped stereo edges caught,
and the reference's stereo edges against the program's pose optimisation."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench.lib.evaluate import camera_centres
from slambench.lib.faults import FAULTS
from slambench.lib.scene import Box, Scene
from slambench.lib.sequence import CameraModel, make_sequence, sensor_of, trajectory
from slambench.reference import pose as P
from slambench.tests.tiny import STEREO_CELL, cpu_run, short_init, tiny_stereo_root

SB = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NO_SHAKE = {"trans_mm": 0.0, "rot_deg": 0.0, "smooth_frames": 3}
FRONTEND_LIMIT = json.loads((SB / "limits" / "tum1.desk.json").read_text())[
    "numbers"]["frontend"]["limit"]


def test_right_view_is_the_left_shifted_by_bf_over_z():
    # A textured wall facing the camera 2 m ahead: every face point at
    # depth z appears in the right view at u - bf / z (6.4 px here).
    z, bf = 2.0, 12.8
    cam = CameraModel(width=96, height=64, fx=80.0, fy=80.0, cx=47.5, cy=31.5, dist=(0.0,) * 5,
                      depth_factor=5000.0, fps=30.0, bf=bf)
    scene = Scene("wall", (Box(lo=(-5.0, z, -5.0), hi=(5.0, z + 0.5, 6.0), inside=False,
                               color=(0.9, 0.8, 0.7), cell=0.06, fine_cell=0.015,
                               contrast=0.7),))
    traffic = {"n_frames": 2, "path": {"center": [0.0, 0.0, 0.0], "radius_m": 1e-3,
                                       "height_m": 1.0, "start_deg": 0.0, "step_mm": 0.0,
                                       "look_at": [1e-3, 5.0, 1.0]},
               "shake": NO_SHAKE, "sensor": {"gray": True}}
    seq = make_sequence(scene, cam, traffic, 2**31 + 3, CPU, sensor="stereo")
    assert seq.colors.shape == seq.rights.shape == (2, 64, 96)
    assert (seq.depths[0] == round(z * cam.depth_factor)).all()
    left, right = seq.colors[0].astype(np.float64), seq.rights[0].astype(np.float64)
    cost = np.array([((left[:, s:] - right[:, :96 - s]) ** 2).mean() for s in range(16)])
    s = int(np.argmin(cost))
    a, b, c = cost[s - 1], cost[s], cost[s + 1]
    shift = s + 0.5 * (a - c) / (a - 2 * b + c)
    assert abs(shift - bf / z) < 0.5, (shift, cost)


def test_travel_heading_looks_along_the_tangent():
    pitch = 10.0
    traffic = {"n_frames": 5, "shake": NO_SHAKE,
               "path": {"center": [0.0, 0.0, 0.0], "radius_m": 50.0, "height_m": 1.65,
                        "start_deg": 30.0, "step_mm": 1000.0, "heading": "travel",
                        "pitch_deg": pitch}}
    poses = trajectory(traffic, 2**31 + 4, CPU)
    c = camera_centres(poses)
    p = math.radians(pitch)
    for i, T in enumerate(poses):
        a = math.radians(30.0) + i * 1.0 / 50.0
        ahead = np.array([-math.sin(a), math.cos(a), 0.0])
        forward = T[2, :3]  # the camera's z axis in the world
        assert np.allclose(forward, math.cos(p) * ahead - [0.0, 0.0, math.sin(p)], atol=1e-9)
        assert abs(c[i, 2] - 1.65) < 1e-9
    # The camera moves the way it looks (the chord turns by half a step).
    move = np.diff(c, axis=0)
    move /= np.linalg.norm(move, axis=1, keepdims=True)
    flat = poses[:-1, 2, :3] * [1.0, 1.0, 0.0]
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    assert np.degrees(np.arccos(np.clip((move * flat).sum(1), -1, 1))).max() < 0.6


def test_stereo_configuration_is_rectified():
    cfg = json.loads((SB / "configs" / "tum1.json").read_text())
    assert sensor_of(cfg) == "rgbd"
    with pytest.raises(ValueError, match="distortion"):
        sensor_of(dict(cfg, sensor="stereo"))
    sysc = {**cfg["system"], **{f"Camera.{k}": 0.0 for k in ("k1", "k2", "p1", "p2", "k3")}}
    assert sensor_of(dict(cfg, sensor="stereo", system=sysc)) == "stereo"
    with pytest.raises(ValueError, match="sensor"):
        sensor_of(dict(cfg, sensor="lidar"))


@pytest.mark.parametrize("fault", [None, "stereo_edges_dropped"],
                         ids=lambda f: "sound" if f is None else f)
def test_tiny_stereo_run(tmp_path, monkeypatch, fault):
    from gsorb_slam_tpu_torch.slam.system import System

    short_init(monkeypatch)
    calls = []
    orig = System.track_stereo
    monkeypatch.setattr(System, "track_stereo",
                        lambda self, *a, **k: calls.append(1) or orig(self, *a, **k))
    if fault is not None:
        FAULTS[fault](monkeypatch.setattr)
    res = cpu_run(tiny_stereo_root(tmp_path), STEREO_CELL)
    assert {"fps", "psnr_db", "setup_s"} <= set(res["metrics"])
    assert len(calls) >= res["attempted"] + 2
    failed = {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}
    if fault is None:
        assert res["correct"] is True, res["checks"]
    else:
        assert res["correct"] is False and "frontend" in failed, res["checks"]


FX, FY, CX, CY, BF = 517.3, 516.5, 318.6, 255.3, 40.0


def _stereo_scene(seed: int, n: int = 400):
    g = torch.Generator().manual_seed(seed)
    world = torch.rand(n, 3, generator=g, dtype=torch.float64) * torch.tensor(
        [3.0, 2.0, 2.0], dtype=torch.float64) - torch.tensor([1.5, 1.0, -1.0],
                                                              dtype=torch.float64)
    xi = torch.tensor([0.05, -0.03, 0.02, 0.02, -0.04, 0.03], dtype=torch.float64)
    T_true = P.se3_exp(xi)
    zero = torch.zeros(n, dtype=torch.float64)
    r, xc = P.residuals(T_true, world, torch.zeros(n, 2, dtype=torch.float64), FX, FY, CX, CY,
                        zero, BF)
    inv_s2 = 1.0 / 1.44 ** torch.randint(0, 3, (n,), generator=g).double()
    noise = torch.randn(n, 3, generator=g, dtype=torch.float64) / inv_s2.sqrt()[:, None]
    uv = r[:, :2] + noise[:, :2]
    ur = r[:, 0] - BF / xc[:, 2] + noise[:, 2]
    ur = torch.where(torch.rand(n, generator=g) < 0.7, ur, torch.full_like(ur, -1.0))
    bad = torch.rand(n, generator=g) < 0.1
    uv[bad] += (torch.rand(int(bad.sum()), 2, generator=g, dtype=torch.float64) - 0.5) * 80
    T_init = P.se3_exp(xi + torch.tensor([0.01, 0.01, -0.01, 0.005, 0.0, -0.005],
                                         dtype=torch.float64))
    return T_true, T_init, world, uv, ur, inv_s2


@pytest.mark.parametrize("seed", [5, 6])
def test_stereo_pose_only_agrees_with_the_program(seed):
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.frontend.ba import pose_optimization

    T_true, T_init, world, uv, ur, inv_s2 = _stereo_scene(seed)
    valid = torch.ones(world.shape[0], dtype=torch.bool)
    cam = Camera(fx=FX, fy=FY, cx=CX, cy=CY, width=640, height=480)
    res = pose_optimization(T_init.float(), world.float(), uv.float(), inv_s2.float(), valid,
                            cam, obs_ur=ur.float(), bf=BF)
    T, inl = P.pose_only(T_init, world.float().double(), uv.float(), inv_s2.float(), valid,
                         FX, FY, CX, CY, obs_ur=ur.float(), bf=BF)
    assert float((T - T_true)[:3].abs().max()) < 2e-3
    assert float((res.T_cw.double() - T)[:3].abs().max()) < FRONTEND_LIMIT
    assert bool((res.inliers == inl).all())
    # Without the stereo edges the solve is another one.
    T_mono, _ = P.pose_only(T_init, world.float().double(), uv.float(), inv_s2.float(), valid,
                            FX, FY, CX, CY)
    assert float((T_mono - T)[:3].abs().max()) > 10 * FRONTEND_LIMIT
