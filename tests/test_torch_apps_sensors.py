"""The port's monocular and stereo drivers on the CPU (the tier-1
counterparts of the slow ``tests/test_cli_drivers.py``):
``run_mono --cpu --type synthetic`` and ``run_stereo --cpu --type
synthetic`` at 96x72 for 3 frames (5 warm-up iterations on frame 0, the
production raster view at small tile capacities) exit 0
and write both trajectory files and a ``result.txt`` line with
``frames_total``; the stereo run tracks every frame.
"""

import dataclasses
import json
import os

import pytest
import torch

from gsorb_slam_tpu_torch.core import config as C
from gsorb_slam_tpu_torch.slam import system as S

torch.set_num_threads(1)

CONFIG = {
    "Dataset": {"name": "sensors_smoke", "type": "synthetic", "path": ""},
    "Camera": {"width": 96, "height": 72, "fx": 90.0, "fy": 90.0, "cx": 48.0, "cy": 36.0,
               "fps": 10.0, "bf": 9.0},
    "ORBextractor": {"nFeatures": 300, "nLevels": 3},
    "Mapping": {"numIters": 3, "maxGaussians": 16384},
    "Tracking": {"numIters": 3},
    "Evalution": {"enable": False, "savePly": False, "saveRootPath": "experiments"},
}
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)


@pytest.mark.parametrize("app", ["run_mono", "run_stereo"])
def test_sensor_app_writes_outputs_on_the_cpu(app, tmp_path, monkeypatch):
    import importlib

    main = importlib.import_module(f"gsorb_slam_tpu_torch.apps.{app}").main
    load = C.load_config
    monkeypatch.setattr(C, "load_config", lambda p: (lambda c: c.replace(
        mapping=dataclasses.replace(c.mapping, init_iters=5)))(load(p)))
    raster = S.System.default_raster_config
    monkeypatch.setattr(S.System, "default_raster_config",
                        staticmethod(lambda w=320: dataclasses.replace(raster(w), **RASTER)))
    cfg = tmp_path / "sensors.json"
    cfg.write_text(json.dumps(CONFIG))
    out = tmp_path / "out"
    rc = main(["--config", str(cfg), "--type", "synthetic", "--max-frames", "3",
               "--out", str(out), "--cpu"])
    assert rc == 0
    for name in ("CameraTrajectory_TUM.txt", "CameraTrajectory_KITTI.txt"):
        assert os.path.exists(out / name)
    res = json.loads((out / "result.txt").read_text().splitlines()[-1])
    assert res["frames_total"] == 3 and res["n_frames"] == 3
    if app == "run_stereo":
        assert len((out / "CameraTrajectory_TUM.txt").read_text().splitlines()) == 3
        assert res["total_gaussians"] > 0
    else:
        assert 0 <= res["frames_tracked"] <= 3
