"""The port's System around its main loop, on the CPU: a checkpoint written
by the JAX package's System loads into the port's (and the port's into the
JAX package's) and tracking continues; the System with the paired-rect and
the exact-stop tracking kernels; ``run_rgbd --cpu`` end to end.

Tolerances: a loaded checkpoint equals its source exactly; a continued or
tracked frame is finite and within 2 cm of the sequence's pose (the
synthetic sequence moves ~1 cm per frame)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import load_config as jload_config
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.core import config as C
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.interop import gaussian_map_to_numpy, system_config_from_dict
from gsorb_slam_tpu_torch.slam import dataset as D
from gsorb_slam_tpu_torch.slam import system as S

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CONFIG = {
    "Camera": {**{k: v for k, v in CAM_KW.items()}, "fps": 10.0},
    "Mapping": {"numIters": 5, "maxGaussians": 16384},
    "Tracking": {"numIters": 10},
}
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)


def _config(cfg):
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=10))


def _port_system(**raster):
    return S.System(_config(system_config_from_dict(CONFIG)), device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(64), **RASTER,
                                               **raster))


def _close_to_gt(T_cw, fr):
    return np.isfinite(T_cw).all() and float(np.abs(T_cw[:3, 3] - fr.gt_T_cw[:3, 3]).max()) < 0.02


def test_jax_checkpoint_loads_and_continues(tmp_path):
    ds = JD.SyntheticDataset(JCamera(**CAM_KW), n_frames=3, n_splats=400, motion_scale=0.2)
    jsys = JS.System(_config(jload_config(CONFIG)), raster=dataclasses.replace(
        JS.System.default_raster_config(64), blend_bf16=False, elem_bf16=False, **RASTER))
    for fr in list(ds)[:2]:
        jsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
    jsys.save_checkpoint(str(tmp_path / "jax"))

    tsys = _port_system()
    tsys.load_checkpoint(str(tmp_path / "jax"))
    got = gaussian_map_to_numpy(tsys.gm)
    for k in ("means", "rgb", "quats", "logit_opacities", "log_scales", "active", "count",
              "adam_t", "scene_radius", "max_z"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jsys.gm, k)), err_msg=k)
    for k, v in jsys.gm.adam_v.items():
        np.testing.assert_array_equal(got["adam_v"][k], np.asarray(v))
    assert tsys.frame_id == 2 and len(tsys.trajectory) == 2
    assert [(k.kf_id, k.frame_id) for k in tsys.keyframes] == [
        (k.kf_id, k.frame_id) for k in jsys.keyframes]
    np.testing.assert_array_equal(tsys.velocity, jsys.velocity)
    assert torch.equal(tsys._kf_colors, torch.as_tensor(np.array(jsys._kf_colors)))

    T_cw = tsys.track_rgbd(ds[2].rgb, ds[2].depth, ds[2].timestamp)
    assert _close_to_gt(T_cw, ds[2]) and len(tsys.trajectory) == 3

    # ... and the port's checkpoint loads into the JAX package's System.
    tsys.save_checkpoint(str(tmp_path / "port"))
    jsys2 = JS.System(_config(jload_config(CONFIG)))
    jsys2.load_checkpoint(str(tmp_path / "port"))
    got = gaussian_map_to_numpy(tsys.gm)
    for k in ("means", "logit_opacities", "count", "adam_t"):
        np.testing.assert_array_equal(np.asarray(getattr(jsys2.gm, k)), got[k], err_msg=k)
    assert jsys2.frame_id == 3 and len(jsys2.trajectory) == 3


@pytest.mark.parametrize("raster", [dict(paired=True), dict(exact_stop=True)],
                         ids=["paired", "exact"])
def test_system_tracks_with_each_kernel_configuration(raster):
    ds = D.SyntheticDataset(Camera(**CAM_KW), n_frames=3, n_splats=400, motion_scale=0.2,
                            device="cpu")
    tsys = _port_system(**raster)
    assert tsys.rcfg_t.tile_h_px == (8 if raster.get("paired") else 16)
    for fr in ds:
        assert _close_to_gt(tsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp), fr)
    assert [r.track_iters for r in tsys.trajectory[1:]] == [10, 10]


def test_run_rgbd_cpu(tmp_path, monkeypatch):
    from gsorb_slam_tpu_torch.apps import run_rgbd

    load = C.load_config
    monkeypatch.setattr(C, "load_config", lambda p: _config(load(p)))
    cfg = tmp_path / "synthetic.yaml"
    cfg.write_text(json.dumps({**CONFIG, "Dataset": {"name": "smoke", "type": "synthetic"}}))
    out = tmp_path / "out"
    assert run_rgbd.main(["--config", str(cfg), "--cpu", "--max-frames", "3", "--out", str(out),
                          "--eval-stride", "1"]) == 0
    for name in ("CameraTrajectory.txt", "CameraTrajectory_TUM.txt", "GaussianModel.ply",
                 "result.txt"):
        assert (out / name).stat().st_size > 0, name
    result = json.loads((out / "result.txt").read_text().splitlines()[-1])
    assert result["n_frames"] == 3 and result["n_eval_frames"] == 3
    assert result["ate_rmse"] < 0.02 and result["psnr"] > 15.0
    # The ORB frontend runs too (tests/test_torch_apps_disk.py holds it on disk data).
    out_orb = tmp_path / "orb"
    assert run_rgbd.main(["--config", str(cfg), "--cpu", "--frontend", "orb", "--max-frames", "2",
                          "--out", str(out_orb), "--no-eval"]) == 0
    assert len((out_orb / "CameraTrajectory.txt").read_text().splitlines()) == 2
