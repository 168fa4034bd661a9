"""Closed-form Sim3 / SE3 alignment and RANSAC for loop verification
(counterpart of ``gsorb_slam_tpu/frontend/sim3.py``).

The reference's ``Sim3Solver`` (``src/Sim3Solver.cc:115-412``): Horn's
method on matched 3D point triples with batched RANSAC hypotheses, and the
image-plane refinement of ``Optimizer::OptimizeSim3``. For RGB-D / stereo
the scale is fixed at 1 (``mbFixScale``), as in the reference. The samples
come from ``frontend.draws.draw_indices(seed, ...)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.transforms import _matmul3, _matvec, se3_exp
from gsorb_slam_tpu_torch.frontend import draws


def _det_sign_diag(U: torch.Tensor, Vt: torch.Tensor) -> torch.Tensor:
    """``diag(1, 1, sign(det(U Vt)))`` batched, ``[..., 3]``."""
    det = torch.linalg.det(_matmul3(U, Vt))
    ones = torch.ones_like(det)
    return torch.stack([ones, ones, torch.sign(det)], -1)


def horn_alignment(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = True):
    """Least-squares ``p2 ~= s R p1 + t`` for ``[..., N, 3]`` sets."""
    mu1 = p1.mean(-2, keepdim=True)
    mu2 = p2.mean(-2, keepdim=True)
    c1, c2 = p1 - mu1, p2 - mu2
    W = (c2[..., :, :, None] * c1[..., :, None, :]).sum(-3)
    U, S, Vt = torch.linalg.svd(W)
    d = _det_sign_diag(U, Vt)
    R = _matmul3(U * d[..., None, :], Vt)
    if fix_scale:
        s = torch.ones(W.shape[:-2], device=W.device)
    else:
        s = (S * d).sum(-1) / torch.clamp((c1 * c1).sum((-1, -2)), min=1e-12)
    t = mu2[..., 0, :] - s[..., None] * _matvec(R, mu1[..., 0, :])
    return s, R, t


class Sim3Result(NamedTuple):
    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    s: torch.Tensor  # []
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int


def ransac_sim3(
    p1: torch.Tensor,  # [N, 3] matched points (frame 1)
    p2: torch.Tensor,  # [N, 3] matched points (frame 2)
    valid: torch.Tensor,  # [N] bool
    seed: int,
    n_hyp: int = 128,
    inlier_th: float = 0.09,  # squared meters (~0.3 m) 3D consistency
    fix_scale: bool = True,
) -> Sim3Result:
    """Batched-hypothesis RANSAC: ``n_hyp`` triples drawn over all ``N``
    rows at once, all scored, the winner refit on its inliers."""
    N = p1.shape[0]
    idx = torch.as_tensor(draws.draw_indices(seed, (n_hyp, 3), max(N, 1)), device=p1.device)
    s, R, t = horn_alignment(p1[idx], p2[idx], fix_scale)
    pred = s[:, None, None] * _matvec(R[:, None], p1[None]) + t[:, None, :]
    err = ((pred - p2[None]) ** 2).sum(-1)
    inl = (err < inlier_th) & valid[None, :]
    binl = inl[torch.argmax(inl.sum(1))]

    w = binl.to(torch.float32)[:, None]
    denom = torch.clamp(w.sum(), min=1.0)
    mu1 = (p1 * w).sum(0) / denom
    mu2 = (p2 * w).sum(0) / denom
    c1 = (p1 - mu1) * w
    c2 = (p2 - mu2) * w
    W = (c2[:, :, None] * c1[:, None, :]).sum(0)
    U, S, Vt = torch.linalg.svd(W)
    d = _det_sign_diag(U, Vt)
    Rr = _matmul3(U * d[None, :], Vt)
    sr = (torch.ones((), device=p1.device) if fix_scale
          else (S * d).sum() / torch.clamp((c1 * c1).sum(), min=1e-12))
    tr = mu2 - sr * _matvec(Rr, mu1)
    pred = sr * _matvec(Rr[None], p1) + tr
    inliers = (((pred - p2) ** 2).sum(-1) < inlier_th) & valid
    return Sim3Result(R=Rr, t=tr, s=sr, inliers=inliers, n_inliers=inliers.sum())


def _huber_w(chi2, delta):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def se3_exp6(xi: torch.Tensor) -> torch.Tensor:
    """exp of a [rho, phi] twist -> [4, 4]."""
    return se3_exp(xi)


def optimize_sim3_reprojection(
    T12_init: torch.Tensor,  # [4, 4] camera1-from-camera2 (SE3; RGB-D fixes s = 1)
    xc2: torch.Tensor,  # [M, 3] matched points in the camera-2 frame
    uv1: torch.Tensor,  # [M, 2] observations in image 1 (undistorted)
    xc1: torch.Tensor,  # [M, 3] matched points in the camera-1 frame
    uv2: torch.Tensor,  # [M, 2] observations in image 2
    inv_sigma2_1: torch.Tensor,  # [M] octave information weights (image 1)
    inv_sigma2_2: torch.Tensor,  # [M]
    valid: torch.Tensor,  # [M] bool
    cam,
    iters: int = 10,
    chi2_th: float = 10.0,
    damping: float = 1e-4,
    fix_scale: bool = True,
    log_s_init: float = 0.0,
):
    """Image-plane refinement of the loop transform (``Optimizer::OptimizeSim3``
    ``src/Optimizer.cc:1047``): bidirectional reprojection edges (point 2
    through S12 into image 1, point 1 through S12^-1 into image 2),
    Huber(sqrt(10)) and a final chi2 <= 10 gate on both, by Gauss-Newton
    over SE3 (``fix_scale``) or 7-DoF Sim3 (a log-scale parameter,
    ``x1 = e^sigma R x2 + t``). The Jacobian is ``torch.func.jacfwd`` at
    zero, as the JAX version's ``jax.jacfwd``. Returns (T12, log_s, inlier
    mask, n_inliers)."""
    huber = float(np.sqrt(chi2_th))
    dof = 6 if fix_scale else 7
    dev = xc2.device

    def proj(xc):
        z = torch.clamp(xc[:, 2], min=1e-3)
        return torch.stack([cam.fx * xc[:, 0] / z + cam.cx, cam.fy * xc[:, 1] / z + cam.cy], -1)

    def residuals(xi, T12, ls):
        T = _matmul3(se3_exp6(xi[:6]), T12)
        s = torch.exp(ls + (0.0 if fix_scale else xi[6]))
        Rm, tm = T[:3, :3], T[:3, 3]
        y1 = s * _matvec(Rm[None], xc2) + tm  # into camera 1
        y2 = _matvec(Rm.T[None], xc1 - tm) / s  # back into camera 2
        r = torch.cat([proj(y1) - uv1, proj(y2) - uv2], dim=-1)
        good = valid & (y1[:, 2] > 1e-2) & (y2[:, 2] > 1e-2)
        return torch.clamp(r, -1e4, 1e4), good

    def chi2_of(r):
        return (inv_sigma2_1 * (r[:, :2] ** 2).sum(-1), inv_sigma2_2 * (r[:, 2:] ** 2).sum(-1))

    T12 = T12_init
    ls = torch.as_tensor(log_s_init, dtype=torch.float32, device=dev)
    zero = torch.zeros(dof, dtype=torch.float32, device=dev)
    eye = torch.eye(dof, device=dev)
    for _ in range(iters):
        r, good = residuals(zero, T12, ls)
        J = torch.func.jacfwd(lambda x: residuals(x, T12, ls)[0])(zero)  # [M, 4, dof]
        c1, c2 = chi2_of(r)
        w1 = inv_sigma2_1 * _huber_w(c1, huber)
        w2 = inv_sigma2_2 * _huber_w(c2, huber)
        w = torch.stack([w1, w1, w2, w2], -1) * good[:, None]
        JtW = J * w[:, :, None]
        H = (JtW[:, :, :, None] * J[:, :, None, :]).sum((0, 1)) + damping * eye
        b = (JtW * r[:, :, None]).sum((0, 1))
        dx = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        T12 = _matmul3(se3_exp6(dx[:6]), T12)
        if not fix_scale:
            ls = ls + dx[6]
    r, good = residuals(zero, T12, ls)
    c1, c2 = chi2_of(r)
    inl = good & (c1 <= chi2_th) & (c2 <= chi2_th)
    return T12, ls, inl, inl.sum()
