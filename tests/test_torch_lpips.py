"""The port's LPIPS (``ops/lpips.py``, ``ops.metrics.lpips``) against the
JAX package's (``ops/lpips_jax.py``, ``ops.metrics.lpips``) on the CPU.

The pretrained AlexNet weights are not in the repository, so every check
runs on seeded random weights written to a temporary ``.npz`` in the
exported layout (``tests/test_losses.py``'s recipe).

- ``lpips_pair`` within 1e-4 relative of the JAX ``lpips_pair`` at 96x128;
  0 on identical images.
- ``metrics.lpips`` with ``GSORB_LPIPS_WEIGHTS`` set: below 1e-6 on
  identical images, above 1e-4 on different ones, symmetric within 1e-5
  relative, equal to ``lpips_pair``; NaN with a warning once the variable
  points nowhere; the module cache is emptied before and after.
- ``apps.replay --lpips`` with the weights: a number within 1e-3 relative of
  the JAX app's (the two renders differ by rounding), and no note.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.apps import replay as j_replay
from gsorb_slam_tpu.ops import lpips_jax as LJ
from gsorb_slam_tpu.ops import metrics as JM
from gsorb_slam_tpu_torch.apps import replay
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.eval.ply import save_gaussian_ply
from gsorb_slam_tpu_torch.eval.trajectory import save_tum
from gsorb_slam_tpu_torch.ops import lpips as LP
from gsorb_slam_tpu_torch.ops import metrics as M
from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset, export_tum_format

torch.set_num_threads(1)


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """Random LPIPS weights in the exported layout, named by
    ``GSORB_LPIPS_WEIGHTS``; both packages' caches are emptied around the
    test."""
    rng = np.random.default_rng(0)
    shapes = [(11, 3, 64), (5, 64, 192), (3, 192, 384), (3, 384, 256), (3, 256, 256)]
    w = {}
    for i, (k, cin, cout) in enumerate(shapes):
        w[f"conv{i}_w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.01, cout).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, cout).astype(np.float32)
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **w)
    monkeypatch.setenv("GSORB_LPIPS_WEIGHTS", str(path))
    monkeypatch.setattr(JM, "_LPIPS_MODEL", None)
    monkeypatch.setattr(JM, "_LPIPS_FAILED", False)
    M.reset_lpips()
    yield str(path)
    M.reset_lpips()


def _pair(rng, h=96, w=128):
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_lpips_pair_matches_jax(weights, rng):
    a, b = _pair(rng)
    assert LP.default_weights_path() == weights
    tw = LP.load_lpips_weights(weights, "cpu")
    assert tw["conv0_w"].shape == (64, 3, 11, 11)
    jw = LJ.load_lpips_weights(weights)
    got = float(LP.lpips_pair(torch.as_tensor(a), torch.as_tensor(b), tw))
    ref = float(LJ.lpips_pair(jnp.asarray(a), jnp.asarray(b), jw))
    assert ref > 1e-3
    assert got == pytest.approx(ref, rel=1e-4)
    assert abs(float(LP.lpips_pair(torch.as_tensor(a), torch.as_tensor(a), tw))) < 1e-6


def test_metrics_lpips_with_weights(weights, rng, monkeypatch):
    a, b = _pair(rng)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    d_same, d_diff, d_flip = M.lpips(ta, ta), M.lpips(ta, tb), M.lpips(tb, ta)
    assert np.isfinite(d_same) and abs(d_same) < 1e-6
    assert d_diff > 1e-4
    assert abs(d_diff - d_flip) < 1e-5 * max(d_diff, 1.0)
    assert d_diff == float(LP.lpips_pair(ta, tb, LP.load_lpips_weights(weights, "cpu")))
    assert list(M._LPIPS_MODEL) == [(weights, torch.device("cpu"))]
    monkeypatch.setenv("GSORB_LPIPS_WEIGHTS", weights + ".missing")
    with pytest.warns(UserWarning):
        assert np.isnan(M.lpips(ta, tb))


def test_replay_lpips_matches_jax(weights, tmp_path, capsys):
    cam_kw = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    ds = SyntheticDataset(Camera(**cam_kw), n_frames=2, n_splats=1500, seed=2, device="cpu")
    export_tum_format(ds, str(tmp_path / "tum"))
    rng = np.random.default_rng(4)
    n = 1500
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(1.5, 3.0, n)], -1).astype(np.float32)
    save_gaussian_ply(str(tmp_path / "map.ply"), means, rng.uniform(0.1, 1, (n, 3)),
                      np.full(n, 3.0, np.float32),
                      np.log(rng.uniform(0.03, 0.08, (n, 3))).astype(np.float32),
                      rng.normal(size=(n, 4)).astype(np.float32))
    save_tum(str(tmp_path / "traj.txt"), [(float(i), ds[i].gt_T_cw) for i in range(len(ds))])
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump({"Camera": {**cam_kw, "fps": 30.0}}, f)
    argv = ["--ply", str(tmp_path / "map.ply"), "--traj", str(tmp_path / "traj.txt"),
            "--config", str(tmp_path / "cfg.json"), "--dataset", str(tmp_path / "tum"),
            "--type", "tum", "--stride", "1", "--lpips"]
    capsys.readouterr()
    assert replay.main(argv + ["--cpu"]) == 0
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j_replay.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mine["frames"] == theirs["frames"] == 2
    assert "lpips_note" not in mine and "lpips_note" not in theirs
    assert mine["lpips"] > 1e-3
    assert mine["lpips"] == pytest.approx(theirs["lpips"], rel=1e-3)
