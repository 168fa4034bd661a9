"""The port's metrics, evaluation files and generated sequences against the
JAX package on the CPU.

Tolerances:
- ``psnr``, ``ms_ssim`` and ``depth_l1``: rtol 1e-5 (float32 sums in
  another order);
- ATE, the TUM trajectory and the PLY: the same numbers and byte-identical
  files (both are numpy code);
- ``SyntheticDataset`` and ``TUMLikeDataset(apply_distortion=False)``:
  poses exact; colors 2e-3 and depths 5e-3 abs (K3's tolerances: the JAX
  package renders them with XLA, the port with the plain blend), except at
  pixels where a rendered alpha sits at the 0.5 depth gate within rounding
  (the depth there is 0 on one side): at most 0.1% of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.eval import ate as JA
from gsorb_slam_tpu.eval import ply as JP
from gsorb_slam_tpu.eval import trajectory as JT
from gsorb_slam_tpu.ops import metrics as JM
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.eval import ate as A
from gsorb_slam_tpu_torch.eval import ply as P
from gsorb_slam_tpu_torch.eval import trajectory as T
from gsorb_slam_tpu_torch.ops import metrics as M
from gsorb_slam_tpu_torch.slam import dataset as D

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_metrics_match_jax(rng):
    pred = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(48, 64)) < 0.7
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.as_tensor(m)
        np.testing.assert_allclose(float(M.psnr(_t(pred), _t(target), tm)),
                                   float(JM.psnr(jnp.asarray(pred), jnp.asarray(target), jm)),
                                   rtol=1e-5)
        d_p, d_t = pred[..., 0] * 4, target[..., 1] * 4
        np.testing.assert_allclose(float(M.depth_l1(_t(d_p), _t(d_t), tm)),
                                   float(JM.depth_l1(jnp.asarray(d_p), jnp.asarray(d_t), jm)),
                                   rtol=1e-5)
    big = rng.uniform(size=(176, 192, 3)).astype(np.float32)
    big_t = np.clip(big + rng.normal(0, 0.1, big.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(M.ms_ssim(_t(big), _t(big_t))),
                               float(JM.ms_ssim(jnp.asarray(big), jnp.asarray(big_t))),
                               rtol=1e-5)
    with pytest.warns(UserWarning):
        assert np.isnan(M.lpips(_t(pred), _t(target)))


def _poses(rng, n):
    out = []
    for _ in range(n):
        q = rng.normal(size=4)
        T_ = np.eye(4, dtype=np.float32)
        T_[:3, :3] = D._quat_to_R(*q)
        T_[:3, 3] = rng.normal(size=3)
        out.append(T_)
    return out


def test_ate_trajectory_and_ply_match_jax(rng, tmp_path):
    gt = _poses(rng, 12)
    est = [T_.copy() for T_ in gt]
    for T_ in est:
        T_[:3, 3] += rng.normal(0, 0.01, 3).astype(np.float32)
    est[3][:3, 3] = np.nan  # a diverged pose is left out
    for scale in (False, True):
        assert A.ate_rmse(est, gt, scale) == JA.ate_rmse(est, gt, scale)
    np.testing.assert_array_equal(np.stack(A.gauge_align_gt_to_est(est, gt)),
                                  np.stack(JA.gauge_align_gt_to_est(est, gt)))
    np.testing.assert_array_equal(D._quat_to_R(0.3, -0.2, 0.5, 0.1),
                                  JD._quat_to_R(0.3, -0.2, 0.5, 0.1))

    traj = [(0.1 * i, T_) for i, T_ in enumerate(gt)]
    for name in ("save_tum", "save_replica", "save_kitti"):
        getattr(T, name)(str(tmp_path / f"{name}.port"), traj)
        getattr(JT, name)(str(tmp_path / f"{name}.jax"), traj)
        assert (tmp_path / f"{name}.port").read_bytes() == (tmp_path / f"{name}.jax").read_bytes()
    back = T.load_tum(str(tmp_path / "save_tum.port"))
    jback = JT.load_tum(str(tmp_path / "save_tum.jax"))
    for (ts, a), (jts, b) in zip(back, jback):
        assert ts == jts and np.array_equal(a, b)
    np.testing.assert_allclose(np.stack([a for _, a in back]), np.stack(gt), atol=1e-5)

    n = 50
    params = (rng.normal(size=(n, 3)), rng.uniform(size=(n, 3)), rng.normal(size=n),
              rng.normal(size=(n, 3)), rng.normal(size=(n, 4)), rng.uniform(size=n) < 0.8)
    assert P.save_gaussian_ply(str(tmp_path / "a.ply"), *params) == JP.save_gaussian_ply(
        str(tmp_path / "b.ply"), *params)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    got, want = P.load_gaussian_ply(str(tmp_path / "a.ply")), JP.load_gaussian_ply(
        str(tmp_path / "b.ply"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _check_frames(port, ref):
    assert len(port) == len(ref)
    worst = 0
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.gt_T_cw, b.gt_T_cw)
        np.testing.assert_allclose(a.rgb, b.rgb, atol=2e-3)
        off = np.abs(a.depth - b.depth) > 5e-3
        # A pixel off by more is one whose alpha crosses the 0.5 gate.
        assert bool(((a.depth == 0) | (b.depth == 0))[off].all())
        worst = max(worst, int(off.sum()))
    assert worst <= 1e-3 * ref[0].depth.size


def test_synthetic_dataset_matches_jax():
    kw = dict(n_frames=3, n_splats=400, seed=1, motion_scale=0.2)
    ref = JD.SyntheticDataset(JCamera(**CAM_KW), **kw)
    port = D.SyntheticDataset(Camera(**CAM_KW), **kw, device="cpu")
    _check_frames(port, ref)
    assert 0.2 < float(np.mean(ref[0].depth > 0)) < 1.0  # the scene has edges


def test_tumlike_dataset_matches_jax():
    kw = dict(n_frames=3, seed=0, width=64, height=48, apply_distortion=False,
              splat_spacing=0.1)
    ref = JD.TUMLikeDataset(**kw)
    port = D.TUMLikeDataset(**kw, device="cpu")
    assert port.cam == Camera(fx=ref.cam.fx, fy=ref.cam.fy, cx=ref.cam.cx, cy=ref.cam.cy,
                              width=64, height=48)
    _check_frames(port, ref)
    with pytest.raises(NotImplementedError):
        D.TUMLikeDataset(n_frames=2, width=64, height=48, device="cpu")
