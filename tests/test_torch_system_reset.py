"""``System.reset()`` and ``start_trace`` / ``stop_trace`` of the port's
System on the CPU: the mirror of ``tests/test_checkpoint.py``'s reset test
(3 frames, reset, 3 frames on the same System), the same run against the
JAX System (its mapping draws replayed across the reset, as
``tests/test_torch_system_parity.py`` replays them; that file's
tolerances: 1 mm and 1 mrad per pose, equal keyframes and windows), and a
trace written on the CPU."""

import dataclasses
import json
import os

import jax
import numpy as np
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import load_config as jload_config
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import (
    CameraConfig,
    MappingConfig,
    SystemConfig,
    TrackingConfig,
)
from gsorb_slam_tpu_torch.interop import system_config_from_dict
from gsorb_slam_tpu_torch.raster import RasterConfig
from gsorb_slam_tpu_torch.slam import dataset as D
from gsorb_slam_tpu_torch.slam import system as S

torch.set_num_threads(1)

CONFIG = {
    "Camera": {"width": 64, "height": 48, "fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0,
               "fps": 10.0},
    "Mapping": {"numIters": 5, "maxGaussians": 16384},
    "Tracking": {"numIters": 10},
}
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
# The JAX System's side: its default raster config blends in bf16.
JRASTER = dict(RASTER, blend_bf16=False, elem_bf16=False)
SEED = 0


def _config(cfg):
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=10))


def _rot_err(A, B):
    R = A[:3, :3].T @ B[:3, :3]
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def test_reset_clears_session_and_tracks_again():
    """The port's mirror of ``tests/test_checkpoint.py``'s reset test."""
    cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    ds = D.SyntheticDataset(cam, n_frames=6, n_splats=1500, seed=3, motion_scale=0.12,
                            device="cpu")
    cfg = SystemConfig(
        camera=CameraConfig(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0, fps=10),
        mapping=MappingConfig(num_iters=15, init_iters=25, max_gaussians=16384, window_size=4,
                              covis_window=2),
        tracking=TrackingConfig(num_iters=20),
    )
    # The JAX test's view at an eighth of its capacity (2048) and half its
    # chunk (128): the plain blends on the CPU scale with both. The tiles
    # then truncate, which the reset checks do not depend on.
    rcfg = RasterConfig(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=8.0)
    s = S.System(cfg, max_keyframes=8, raster=rcfg, seed=0, device="cpu")
    for i in range(3):
        s.track_rgbd(ds[i].rgb, ds[i].depth, float(i))
    assert s.frame_id == 3 and len(s.keyframes) >= 1
    assert int(s.gm.count) > 0
    pools = (s._kf_colors, s._kf_depths, s._kf_bins_idx, s._kf_bins_cnt)
    ptrs = [p.data_ptr() for p in pools]
    n_track = s.timings["n_track"]

    s.reset()
    assert s.frame_id == 0
    assert s.keyframes == [] and s.last_kf is None
    assert s.trajectory == [] and s.loop_events == []
    assert s.densify_added == [] and s._bin_stats == []
    assert int(s.gm.count) == 0 and not bool(s.gm.active.any())
    np.testing.assert_array_equal(s.velocity, np.eye(4, dtype=np.float32))
    # The pools are zeroed in place; the timings survive.
    assert [p.data_ptr() for p in pools] == ptrs
    assert not s._kf_colors.any() and not s._kf_depths.any() and not s._kf_bins_cnt.any()
    assert bool((s._kf_bins_idx == -1).all())
    assert s.timings["n_track"] == n_track

    # A fresh session on the same System instance.
    for i in range(3):
        T = s.track_rgbd(ds[i].rgb, ds[i].depth, float(i))
    assert s.frame_id == 3 and np.all(np.isfinite(T))
    assert float(np.abs(T[:3, 3] - ds[2].gt_T_cw[:3, 3]).max()) < 0.02


def test_reset_matches_jax_across_the_reset(monkeypatch):
    ds = JD.SyntheticDataset(JCamera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48),
                             n_frames=3, n_splats=400, motion_scale=0.2)
    jsys = JS.System(_config(jload_config(CONFIG)), seed=SEED, raster=dataclasses.replace(
        JS.System.default_raster_config(64), backend="pallas", **JRASTER))
    tsys = S.System(_config(system_config_from_dict(CONFIG)), seed=SEED, device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(64), **RASTER))
    key = [jax.random.PRNGKey(SEED)]

    def jax_draws(n_iters, n_frames):
        """The JAX System's draws (one key split per mapping call, one
        randint per iteration); its key is not reset."""
        key[0], sub = jax.random.split(key[0])
        keys = jax.random.split(sub, n_iters)
        return [int(jax.random.randint(k, (), 0, max(int(n_frames), 1))) for k in keys]

    monkeypatch.setattr(tsys, "_mapping_draws", jax_draws)

    for session in range(2):
        for fr in ds:
            T_j = jsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
            T_t = tsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
            assert np.isfinite(T_t).all()
            assert float(np.abs(T_t[:3, 3] - T_j[:3, 3]).max()) < 1e-3, session
            assert _rot_err(T_t, T_j) < 1e-3, session
        assert [r.is_keyframe for r in tsys.trajectory] == [
            r.is_keyframe for r in jsys.trajectory]
        assert [(k.kf_id, k.frame_id) for k in tsys.keyframes] == [
            (k.kf_id, k.frame_id) for k in jsys.keyframes]
        np.testing.assert_allclose(tsys.densify_added, jsys.densify_added, rtol=1e-2, atol=1)
        if session == 0:
            jsys.reset()
            tsys.reset()
            assert tsys.frame_id == jsys.frame_id == 0
            assert int(tsys.gm.count) == int(jsys.gm.count) == 0
    assert len(tsys.trajectory) == 3 and tsys.shutdown_summary()["n_frames"] == 3


def test_trace_written_on_the_cpu(tmp_path):
    cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    ds = D.SyntheticDataset(cam, n_frames=2, n_splats=400, motion_scale=0.2, device="cpu")
    s = S.System(_config(system_config_from_dict(CONFIG)), seed=SEED, device="cpu",
                 raster=dataclasses.replace(S.System.default_raster_config(64), **RASTER))
    s.track_rgbd(ds[0].rgb, ds[0].depth, 0.0)
    log_dir = str(tmp_path / "trace")
    s.start_trace(log_dir)
    s.track_rgbd(ds[1].rgb, ds[1].depth, 1.0)
    path = s.stop_trace()
    assert os.path.dirname(path) == log_dir and os.listdir(log_dir) == [os.path.basename(path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert s.frame_id == 2
