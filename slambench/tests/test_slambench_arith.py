"""The end-to-end arithmetic on hand-made inputs: fps, ATE after Horn's
alignment, PSNR, the frame-time percentile, the idle share."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

from slambench.lib.evaluate import ate_rmse, camera_centres, horn_align
from slambench.lib.trace import TraceSummary, _union_len
from slambench.reference.render import psnr

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def poses_from_centres(c: np.ndarray) -> np.ndarray:
    T = np.tile(np.eye(4), (len(c), 1, 1))
    T[:, :3, 3] = -c  # identity rotation: t = -C
    return T


def rot_z(a: float) -> np.ndarray:
    return np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])


def test_ate_is_zero_up_to_a_rigid_motion():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(20, 3))
    est = gt @ rot_z(0.3).T + np.array([1.0, -2.0, 0.5])
    R, t = horn_align(est, gt)
    assert np.allclose(est @ R.T + t, gt, atol=1e-12)
    assert ate_rmse(poses_from_centres(est), poses_from_centres(gt)) < 1e-12


def test_ate_of_a_known_offset():
    gt = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]])
    # Alternate +-1 mm along z: no rigid motion removes it.
    est = gt + np.array([[0, 0, 1e-3], [0, 0, -1e-3], [0, 0, -1e-3], [0, 0, 1e-3]])
    assert math.isclose(ate_rmse(poses_from_centres(est), poses_from_centres(gt)), 1e-3,
                        rel_tol=1e-9)


def test_camera_centres():
    T = np.eye(4)[None].copy()
    T[0, :3, :3] = rot_z(0.5)
    C = np.array([0.3, -0.1, 2.0])
    T[0, :3, 3] = -rot_z(0.5) @ C
    assert np.allclose(camera_centres(T)[0], C)


def test_psnr_of_a_known_error():
    gt = torch.zeros((4, 4, 3))
    pred = gt + 0.1
    mask = torch.ones((4, 4), dtype=torch.bool)
    mask[0, 0] = False
    pred[0, 0] = 1.0  # masked out
    assert math.isclose(psnr(pred, gt, mask), 20.0, rel_tol=1e-6)


def test_fps_and_frame_time_readers():
    ctx = {"window": {"frames": 17, "seconds": 51.0, "frame_s": [3.0] * 9 + [4.0],
                      "timings": {"track": 2.0, "map": 6.0, "n_map": 4, "frontend": 0.5,
                                  "kf": 0.5},
                      "track_iters": [200, 200, 100, 100]}}
    assert math.isclose(reader("fps")(ctx), 1 / 3)
    assert math.isclose(reader("system.frame_ms.p90")(ctx), 3100.0)
    assert math.isclose(reader("tracking.ms_per_iter")(ctx), 2000.0 / 600)
    assert math.isclose(reader("tracking.iters_per_frame")(ctx), 150.0)
    assert math.isclose(reader("mapping.ms_per_frame")(ctx), 1500.0)
    assert math.isclose(reader("frontend.ms_per_frame")(ctx), 1000.0 / 17)


def test_idle_share_and_union():
    busy, gaps = _union_len([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)], 0.0, 10.0)
    assert busy == 4.0
    assert gaps == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    ctx = {"trace": TraceSummary(busy_s=2.5, window_s=10.0)}
    assert math.isclose(reader("device.idle")(ctx), 75.0)
    assert reader("device.idle")({"trace": None}) is None


def test_roofline_readers_are_silent_without_a_trace():
    assert reader("kernels.track_roofline")({"trace": None, "roofline": {}}) is None
    tr = TraceSummary(busy_s=1.0, window_s=2.0,
                      kernel_s_by_range={"slambench.track": 0.5})
    ctx = {"trace": tr, "roofline": {"track_least_s": 0.05, "map_least_s": 0.1}}
    assert math.isclose(reader("kernels.track_roofline")(ctx), 10.0)
    assert reader("kernels.map_roofline")(ctx) is None
