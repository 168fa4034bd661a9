"""The plain reference of the ORB frontend's pose seed: motion-only bundle
adjustment (ORB-SLAM2's ``Optimizer::PoseOptimization``) written from the
equations in plain PyTorch, importing nothing of the program.

From the motion model's predicted pose and the frame's matches (map
points, keypoints, the inverse variance of each keypoint's octave) it
minimises sum_i rho(invSigma2_i ||pi(T X_i) - u_i||^2) over the camera
pose by Gauss-Newton on a left twist [rho, phi]: rho is Huber's kernel
with delta sqrt(5.991) on the chi^2, the schedule 4 rounds of 10
iterations, each round ending in a re-gate of every match at chi^2 <=
5.991 (the 95% bound of 2 degrees of freedom) for the next round, and
the last pose's gate marks the inliers. Matches at z <= 1e-2 in front of
the camera weigh nothing. A damping of 1e-4 on the normal equations
keeps a thin round solvable and does not move the minimum.

The projection and the normal equations are matrix products (``@``), so
the card's matmul precision is the reference's: the judge runs it in
float64, the lower-precision control in float32 with TF32 on.
"""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991
HUBER = math.sqrt(CHI2_MONO)
ROUNDS = 4
ITERS = 10
DAMPING = 1e-4
MIN_Z = 1e-2


def skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """The 4x4 matrix of the twist ``[rho, phi]`` (Rodrigues)."""
    rho, phi = xi[:3], xi[3:]
    th = phi.norm()
    W = skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if float(th) < 1e-10:
        R, V = eye + W, eye + 0.5 * W
    else:
        a = torch.sin(th) / th
        b = (1 - torch.cos(th)) / th ** 2
        c = (th - torch.sin(th)) / th ** 3
        R = eye + a * W + b * (W @ W)
        V = eye + b * W + c * (W @ W)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def residuals(T: torch.Tensor, world: torch.Tensor, obs_uv: torch.Tensor, fx: float,
              fy: float, cx: float, cy: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Reprojection residuals ``[M, 2]`` (pixels) and camera points ``[M, 3]``."""
    xc = world @ T[:3, :3].T + T[:3, 3]
    z = torch.clamp(xc[:, 2], min=1e-6)
    r = torch.stack([fx * xc[:, 0] / z + cx - obs_uv[:, 0],
                     fy * xc[:, 1] / z + cy - obs_uv[:, 1]], -1)
    return r, xc


def jacobian(xc: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """d residual / d [rho, phi] of a left update, ``[M, 2, 6]``."""
    x, y, z = xc[:, 0], xc[:, 1], torch.clamp(xc[:, 2], min=MIN_Z)
    # d pi / d xc  [M, 2, 3]  times  d xc / d xi = [I | -[xc]x]  [M, 3, 6]
    zero = torch.zeros_like(z)
    dpi = torch.stack([torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
                       torch.stack([zero, fy / z, -fy * y / z ** 2], -1)], 1)
    one = torch.ones_like(z)
    dxc = torch.stack([
        torch.stack([one, zero, zero, zero, xc[:, 2], -xc[:, 1]], -1),
        torch.stack([zero, one, zero, -xc[:, 2], zero, xc[:, 0]], -1),
        torch.stack([zero, zero, one, xc[:, 1], -xc[:, 0], zero], -1)], 1)
    return dpi @ dxc


def pose_only(T_init: torch.Tensor, world: torch.Tensor, obs_uv: torch.Tensor,
              inv_sigma2: torch.Tensor, valid: torch.Tensor, fx: float, fy: float, cx: float,
              cy: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The optimised pose ``[4, 4]`` and the inlier mask ``[M]``, in the
    dtype of ``world``."""
    dt = world.dtype
    T = T_init.to(dt)
    obs_uv, inv_sigma2 = obs_uv.to(dt), inv_sigma2.to(dt)
    gate = torch.ones_like(valid)
    eye6 = torch.eye(6, dtype=dt, device=world.device)
    for _ in range(ROUNDS):
        for _ in range(ITERS):
            r, xc = residuals(T, world, obs_uv, fx, fy, cx, cy)
            c2 = inv_sigma2 * (r * r).sum(-1)
            e = torch.sqrt(torch.clamp(c2, min=1e-12))
            w = inv_sigma2 * torch.where(e <= HUBER, torch.ones_like(e), HUBER / e)
            w = torch.where(valid & gate & (xc[:, 2] > MIN_Z), w, torch.zeros_like(w))
            J = jacobian(xc, fx, fy).reshape(-1, 6)
            Jw = J * w.repeat_interleave(2)[:, None]
            H = Jw.T @ J + DAMPING * eye6
            b = Jw.T @ r.reshape(-1)
            T = se3_exp(-torch.linalg.solve(H, b)) @ T
        r, _ = residuals(T, world, obs_uv, fx, fy, cx, cy)
        gate = inv_sigma2 * (r * r).sum(-1) <= CHI2_MONO
    return T, valid & gate
