"""Absolute trajectory error via Horn alignment.

The port's own numpy copy of ``gsorb_slam_tpu/eval/ate.py``.

Equivalent of ``scripts/tum_ate.py:47-79`` (align) and the RMSE print at
``:162`` — the closed-form similarity/rigid alignment of estimated vs
ground-truth camera centers followed by RMSE of the residuals.
"""

from __future__ import annotations

import numpy as np


def horn_align(
    model: np.ndarray, data: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (optionally Sim3) alignment model -> data.

    ``model``/``data``: [N, 3] corresponding points. Returns (R, t, s) with
    ``data ~= s * R @ model + t``.
    """
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    if with_scale:
        s = float((S * np.diag(D)).sum() / (mc**2).sum())
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return R, t, s


def ate_rmse(
    est_T_cw: list[np.ndarray] | np.ndarray,
    gt_T_cw: list[np.ndarray] | np.ndarray,
    with_scale: bool = False,
) -> float:
    """ATE RMSE (meters) between aligned camera-center trajectories.

    Non-finite estimated poses (a diverged tracker) are excluded from the
    alignment pairs rather than crashing the SVD; if every pose is bad the
    result is ``inf`` (matching how a fully lost run should score)."""
    est_c = np.stack([_center(T) for T in est_T_cw])
    gt_c = np.stack([_center(T) for T in gt_T_cw])
    ok = np.isfinite(est_c).all(axis=1) & np.isfinite(gt_c).all(axis=1)
    if not ok.all():
        if ok.sum() < 3:
            return float("inf")
        est_c, gt_c = est_c[ok], gt_c[ok]
    R, t, s = horn_align(est_c, gt_c, with_scale)
    aligned = est_c @ (s * R).T + t
    err = aligned - gt_c
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def gauge_align_gt_to_est(
    est_T_cw: list[np.ndarray] | np.ndarray,
    gt_T_cw: list[np.ndarray] | np.ndarray,
) -> list[np.ndarray]:
    """Express GT camera poses in the ESTIMATED trajectory's gauge.

    A SLAM map is only defined up to a rigid transform (the gauge the
    first keyframe pins); rendering the map at RAW GT poses conflates
    that rigid offset with real map damage. This computes the Horn
    alignment est->gt from camera centers (the same alignment ATE uses)
    and returns ``T_cw_gt @ S`` where ``S = [R | t]`` maps est-world ->
    gt-world — i.e. GT poses re-expressed over the map's world frame, so
    a GT-pose render twin scores map quality with both eval-pose error
    AND gauge freedom removed.
    """
    est_c = np.stack([_center(T) for T in est_T_cw])
    gt_c = np.stack([_center(T) for T in gt_T_cw])
    ok = np.isfinite(est_c).all(axis=1) & np.isfinite(gt_c).all(axis=1)
    if ok.sum() < 3:
        return [np.asarray(T, np.float32) for T in gt_T_cw]
    R, t, _ = horn_align(est_c[ok], gt_c[ok])  # x_gt ~= R x_est + t
    S = np.eye(4, dtype=np.float64)
    S[:3, :3] = R
    S[:3, 3] = t
    return [np.asarray(np.asarray(T, np.float64) @ S, np.float32)
            for T in gt_T_cw]


def _center(T_cw: np.ndarray) -> np.ndarray:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    return -R.T @ t
