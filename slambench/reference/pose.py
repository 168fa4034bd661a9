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

On a stereo frame (``obs_ur`` given) a match with a right-image
coordinate ``obs_ur >= 0`` is ORB-SLAM2's
``EdgeStereoSE3ProjectXYZOnlyPose``: three residuals ``[u, v, uR]`` with
the right one predicted at ``u - bf / z``, weighted by the same
``invSigma2``, gated at chi^2 <= 7.815 (3 degrees of freedom) and with
Huber's delta sqrt(7.815); the others stay monocular as above. Residuals
are prediction minus observation (the source's sign flipped, which moves
no step).

The projection and the normal equations are matrix products (``@``), so
the card's matmul precision is the reference's: the judge runs it in
float64, the lower-precision control in float32 with TF32 on.
"""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991
HUBER = math.sqrt(CHI2_MONO)
CHI2_STEREO = 7.815
HUBER_STEREO = math.sqrt(CHI2_STEREO)
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
              fy: float, cx: float, cy: float, obs_ur: torch.Tensor | None = None,
              bf: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Reprojection residuals ``[M, 2]`` (pixels; ``[M, 3]`` with
    ``obs_ur``, the third 0 on a monocular match) and camera points
    ``[M, 3]``."""
    xc = world @ T[:3, :3].T + T[:3, 3]
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = fx * xc[:, 0] / z + cx
    r = torch.stack([u - obs_uv[:, 0], fy * xc[:, 1] / z + cy - obs_uv[:, 1]], -1)
    if obs_ur is not None:
        r_ur = torch.where(obs_ur >= 0, u - bf / z - obs_ur, torch.zeros_like(z))
        r = torch.cat([r, r_ur[:, None]], -1)
    return r, xc


def jacobian(xc: torch.Tensor, fx: float, fy: float, obs_ur: torch.Tensor | None = None,
             bf: float = 0.0) -> torch.Tensor:
    """d residual / d [rho, phi] of a left update, ``[M, 2, 6]`` (``[M, 3,
    6]`` with ``obs_ur``)."""
    x, y, z = xc[:, 0], xc[:, 1], torch.clamp(xc[:, 2], min=MIN_Z)
    # d pi / d xc  [M, 2, 3]  times  d xc / d xi = [I | -[xc]x]  [M, 3, 6]
    zero = torch.zeros_like(z)
    rows = [torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
            torch.stack([zero, fy / z, -fy * y / z ** 2], -1)]
    if obs_ur is not None:
        # uR = u - bf / z: d/d xc = d u / d xc + [0, 0, bf / z^2].
        ur = torch.stack([fx / z, zero, (bf - fx * x) / z ** 2], -1)
        rows.append(torch.where((obs_ur >= 0)[:, None], ur, torch.zeros_like(ur)))
    dpi = torch.stack(rows, 1)
    one = torch.ones_like(z)
    dxc = torch.stack([
        torch.stack([one, zero, zero, zero, xc[:, 2], -xc[:, 1]], -1),
        torch.stack([zero, one, zero, -xc[:, 2], zero, xc[:, 0]], -1),
        torch.stack([zero, zero, one, xc[:, 1], -xc[:, 0], zero], -1)], 1)
    return dpi @ dxc


def pose_only(T_init: torch.Tensor, world: torch.Tensor, obs_uv: torch.Tensor,
              inv_sigma2: torch.Tensor, valid: torch.Tensor, fx: float, fy: float, cx: float,
              cy: float, obs_ur: torch.Tensor | None = None, bf: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The optimised pose ``[4, 4]`` and the inlier mask ``[M]``, in the
    dtype of ``world``. ``obs_ur`` (``[M]``, < 0 on a monocular match) and
    ``bf`` make the matches with a right-image coordinate stereo edges."""
    dt = world.dtype
    T = T_init.to(dt)
    obs_uv, inv_sigma2 = obs_uv.to(dt), inv_sigma2.to(dt)
    huber, chi2_th = HUBER, CHI2_MONO
    if obs_ur is not None:
        obs_ur = obs_ur.to(dt)
        stereo = obs_ur >= 0
        huber = torch.where(stereo, HUBER_STEREO, HUBER).to(dt)
        chi2_th = torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    gate = torch.ones_like(valid)
    eye6 = torch.eye(6, dtype=dt, device=world.device)
    for _ in range(ROUNDS):
        for _ in range(ITERS):
            r, xc = residuals(T, world, obs_uv, fx, fy, cx, cy, obs_ur, bf)
            c2 = inv_sigma2 * (r * r).sum(-1)
            e = torch.sqrt(torch.clamp(c2, min=1e-12))
            w = inv_sigma2 * torch.where(e <= huber, torch.ones_like(e), huber / e)
            w = torch.where(valid & gate & (xc[:, 2] > MIN_Z), w, torch.zeros_like(w))
            J = jacobian(xc, fx, fy, obs_ur, bf).reshape(-1, 6)
            Jw = J * w.repeat_interleave(r.shape[1])[:, None]
            H = Jw.T @ J + DAMPING * eye6
            b = Jw.T @ r.reshape(-1)
            T = se3_exp(-torch.linalg.solve(H, b)) @ T
        r, _ = residuals(T, world, obs_uv, fx, fy, cx, cy, obs_ur, bf)
        gate = inv_sigma2 * (r * r).sum(-1) <= chi2_th
    return T, valid & gate
