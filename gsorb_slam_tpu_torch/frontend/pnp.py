"""Robust PnP for relocalization (counterpart of
``gsorb_slam_tpu/frontend/pnp.py``).

The reference's ``PnPsolver`` (EPnP + RANSAC, ``src/PnPsolver.cc:121-1020``)
as a batched-hypothesis DLT-PnP RANSAC: H hypotheses of 6
correspondences each are solved with one batched SVD on the device, scored
by reprojection, and the winner is polished with the robust pose
optimizer. Used by relocalization (``Tracking::Relocalization``
``src/Tracking.cc:1718-1879``). The samples come from
``frontend.draws.draw_indices(seed, ...)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.transforms import _matmul3, _matvec
from gsorb_slam_tpu_torch.frontend import draws
from gsorb_slam_tpu_torch.frontend.ba import pose_optimization


def _dlt_pose_batch(X: torch.Tensor, uv_n: torch.Tensor) -> torch.Tensor:
    """Batched 6-point DLT: ``[H, 6, 3]`` world points and ``[H, 6, 2]``
    normalized image coords -> ``[H, 3, 4]`` (R | t), the rotation
    orthonormalized and the scale and sign fixed (so the SVD's sign does not
    matter)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    u, v = uv_n[..., 0], uv_n[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    ru = torch.stack([x, y, z, one, zero, zero, zero, zero, -u * x, -u * y, -u * z, -u], -1)
    rv = torch.stack([zero, zero, zero, zero, x, y, z, one, -v * x, -v * y, -v * z, -v], -1)
    A = torch.stack([ru, rv], dim=2).reshape(X.shape[0], -1, 12)  # rows u0, v0, u1, ...
    P = torch.linalg.svd(A).Vh[:, -1].reshape(-1, 3, 4)
    U, S, Vt = torch.linalg.svd(P[:, :, :3])
    det = torch.linalg.det(_matmul3(U, Vt))
    sgn = torch.sign(det)
    Rn = _matmul3(U * sgn[:, None, None], Vt)
    scale = sgn * 3.0 / torch.clamp(S.sum(-1), min=1e-12)
    return torch.cat([Rn, (P[:, :, 3] * scale[:, None])[:, :, None]], dim=2)


class PnPResult(NamedTuple):
    T_cw: np.ndarray
    inliers: np.ndarray
    n_inliers: int


def ransac_pnp(
    world: np.ndarray,  # [N, 3]
    obs_uv: np.ndarray,  # [N, 2] pixels
    valid: np.ndarray,  # [N] bool
    cam: Camera,
    seed: int = 0,
    n_hyp: int = 256,
    reproj_th: float = 5.99,
    min_inliers: int = 12,
    device: torch.device | str = "cuda",
) -> Optional[PnPResult]:
    N = len(world)
    if valid.sum() < 6:
        return None
    vidx = np.nonzero(valid)[0]
    idx = vidx[draws.draw_indices(seed, (n_hyp, 6), len(vidx))]
    Kinv = np.linalg.inv(np.asarray([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                                     [0.0, 0.0, 1.0]], np.float32))
    uv_h = np.concatenate([obs_uv, np.ones((N, 1), np.float32)], 1)
    uv_n = (uv_h @ Kinv.T)[:, :2].astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    P = _dlt_pose_batch(t(world[idx]), t(uv_n[idx]))
    # Score: the reprojection error of every point under every hypothesis.
    Xw = t(world)
    xc = _matvec(P[:, None, :, :3], Xw[None]) + P[:, None, :, 3]
    z = xc[..., 2]
    ok_z = z > 1e-3
    zs = torch.where(ok_z, z, torch.ones_like(z))
    uo = t(obs_uv)
    u = cam.fx * xc[..., 0] / zs + cam.cx
    v = cam.fy * xc[..., 1] / zs + cam.cy
    err = (u - uo[None, :, 0]) ** 2 + (v - uo[None, :, 1]) ** 2
    inl = ok_z & (err < reproj_th**2) & torch.as_tensor(valid, device=device)[None]
    scores = inl.sum(1)
    best = int(torch.argmax(scores))
    if int(scores[best]) < min_inliers:
        return None
    T0 = torch.eye(4, device=device)
    T0[:3, :] = P[best]
    res = pose_optimization(T0, Xw, uo, torch.ones(N, device=device), inl[best], cam)
    inliers = res.inliers.cpu().numpy()
    if inliers.sum() < min_inliers:
        return None
    return PnPResult(T_cw=res.T_cw.cpu().numpy(), inliers=inliers, n_inliers=int(inliers.sum()))
