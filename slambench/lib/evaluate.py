"""End-to-end arithmetic the benchmark does itself: ATE after Horn's
alignment."""

from __future__ import annotations

import numpy as np


def camera_centres(T_cw: np.ndarray) -> np.ndarray:
    """``[N, 4, 4]`` world -> camera transforms -> camera centres ``[N, 3]``."""
    T = np.asarray(T_cw, np.float64)
    R, t = T[:, :3, :3], T[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def horn_align(est: np.ndarray, gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rotation and translation (no scale) that best map ``est`` onto
    ``gt`` in least squares (Horn 1987, by SVD)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    return R, mu_g - R @ mu_e


def ate_rmse(est_T_cw: np.ndarray, gt_T_cw: np.ndarray) -> float:
    """RMSE (metres) of the camera centres after Horn's alignment."""
    e, g = camera_centres(est_T_cw), camera_centres(gt_T_cw)
    R, t = horn_align(e, g)
    res = e @ R.T + t - g
    return float(np.sqrt((res ** 2).sum(1).mean()))

