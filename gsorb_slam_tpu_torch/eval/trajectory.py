"""Trajectory savers/loaders for the four dataset formats.

The port's own numpy copy of ``gsorb_slam_tpu/eval/trajectory.py``.

Equivalent of the reference savers ``SaveTrajectoryTUM`` /
``SaveTrajectoryReplica`` / ``SaveTrajectoryScannet`` / ``SaveTrajectoryKITTI``
(``src/System.cc:403-664``). All take ``[(timestamp, T_cw)]``.
"""

from __future__ import annotations

import numpy as np


def _T_wc(T_cw: np.ndarray) -> np.ndarray:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ t
    return T


def _quat_wxyz(R: np.ndarray) -> tuple[float, float, float, float]:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return float(w), float(x), float(y), float(z)


def save_tum(path: str, traj: list[tuple[float, np.ndarray]]) -> None:
    """``timestamp tx ty tz qx qy qz qw`` of the camera-in-world pose."""
    with open(path, "w") as f:
        for ts, T_cw in traj:
            T = _T_wc(np.asarray(T_cw))
            w, x, y, z = _quat_wxyz(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {x:.7f} {y:.7f} {z:.7f} {w:.7f}\n")


def save_replica(path: str, traj: list[tuple[float, np.ndarray]]) -> None:
    """One row-major flattened 4x4 T_wc per line (Replica traj.txt format)."""
    with open(path, "w") as f:
        for _, T_cw in traj:
            f.write(" ".join(f"{v:.9f}" for v in _T_wc(np.asarray(T_cw)).reshape(-1)))
            f.write("\n")


save_scannet = save_replica  # same row-major matrix-per-line convention


def save_kitti(path: str, traj: list[tuple[float, np.ndarray]]) -> None:
    """3x4 row-major T_wc per line."""
    with open(path, "w") as f:
        for _, T_cw in traj:
            f.write(
                " ".join(f"{v:.9f}" for v in _T_wc(np.asarray(T_cw))[:3].reshape(-1))
            )
            f.write("\n")


def load_tum(path: str) -> list[tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, tx, ty, tz, qx, qy, qz, qw = (float(v) for v in line.split()[:8])
            n = np.sqrt(qw**2 + qx**2 + qy**2 + qz**2)
            qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
            R = np.array(
                [
                    [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                    [2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qw * qx)],
                    [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx**2 + qy**2)],
                ]
            )
            T_wc = np.eye(4)
            T_wc[:3, :3] = R
            T_wc[:3, 3] = [tx, ty, tz]
            out.append((t, np.linalg.inv(T_wc).astype(np.float32)))
    return out
