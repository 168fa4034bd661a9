"""Bundle-adjustment solvers, the g2o layer (counterpart of
``gsorb_slam_tpu/frontend/ba.py``).

The reference's g2o usage (``src/Optimizer.cc``) as robust Gauss-Newton /
Levenberg-Marquardt in PyTorch on the tensors' device:

- :func:`pose_optimization` = ``Optimizer::PoseOptimization``
  (``src/Optimizer.cc:239-452``): 4 rounds of 10 iterations on one SE3
  pose, Huber delta sqrt(5.991), chi^2 re-gating between rounds;
- :func:`local_bundle_adjustment` = ``Optimizer::LocalBundleAdjustment``
  (``:453-780``): block-coordinate Gauss-Seidel, a closed-form 3x3 update
  per point then a 6x6 update per pose;
- :func:`pose_graph_optimization` and :func:`sim3_pose_graph_optimization`
  = ``OptimizeEssentialGraph`` (``:782-1045``), SE3 and Sim3.

Poses move by se(3) twists on the left (``se3_exp``). The normal equations
are sums over observations or edges into poses and points. They never add
with float atomics (``index_add_`` on CUDA would, and the sums would then
change from run to run): :class:`Segments` sorts the target index once per
call with a stable sort, lays each target's terms out in a dense
``[targets, max terms]`` block and sums along it, an order fixed by the
data. Contractions are explicit float32 products and sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.transforms import (
    _matmul3,
    _matvec,
    invert_se3,
    se3_exp,
    se3_log,
    skew,
)

CHI2_MONO = 5.991
HUBER_MONO = math.sqrt(CHI2_MONO)
CHI2_STEREO = 7.815  # 95% chi^2, 3 DoF (src/Optimizer.cc:300-380 edges)
HUBER_STEREO = math.sqrt(CHI2_STEREO)


class Segments:
    """A fixed-order segment sum over ``index [O]`` into ``n`` targets.

    The layout (a stable sort by target, each term's rank within its
    target) is built once; :meth:`sum` scatters the terms into a zeroed
    ``[n, max terms, ...]`` block (each slot written once) and sums along
    the terms, so the result does not depend on thread scheduling."""

    def __init__(self, index: torch.Tensor, n: int):
        index = index.long()
        self.n = n
        order = torch.sort(index, stable=True).indices
        counts = torch.bincount(index, minlength=n)
        starts = torch.cumsum(counts, 0) - counts
        seg = index[order]
        rank = torch.arange(index.numel(), device=index.device) - starts[seg]
        self.width = max(int(counts.max()) if index.numel() else 0, 1)
        self.order = order
        self.slot = seg * self.width + rank

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        tail = values.shape[1:]
        buf = torch.zeros((self.n * self.width,) + tail, dtype=values.dtype,
                          device=values.device)
        buf[self.slot] = values[self.order]
        return buf.view((self.n, self.width) + tail).sum(1)


def _outer_sum(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``einsum("mri,mrj->mij")``: per-term ``A^T B`` over the residual rows."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(-3)


def _rows_dot(A: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``einsum("mri,mr->mi")``."""
    return (A * r[..., :, None]).sum(-2)


def _solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``H x = b`` for vector right-hand sides; no check (a singular
    system gives non-finite values, as the JAX solve does)."""
    return torch.linalg.solve_ex(H, b[..., None])[0][..., 0]


def _project_residual(T_cw, world, obs_uv, cam: Camera):
    """Residual [M, 2] and camera point [M, 3]."""
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    xc = _matvec(R[None], world) + t
    z = torch.where(xc[:, 2] > 1e-6, xc[:, 2], torch.full_like(xc[:, 2], 1e-6))
    u = cam.fx * xc[:, 0] / z + cam.cx
    v = cam.fy * xc[:, 1] / z + cam.cy
    return torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1]], -1), xc


def _pose_jacobian(xc, cam: Camera):
    """d(residual) / d(twist [rho, phi]) in the camera frame: [M, 2, 6].

    z clamps at 1e-2: with z ~ 1e-6 the fx x / z^2 terms overflow f32 once
    squared into the normal equations, and inf times a zero robust weight
    is NaN. Callers weight points behind the camera out."""
    x, y, z = xc[:, 0], xc[:, 1], torch.clamp(xc[:, 2], min=1e-2)
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(z)
    ju = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2,
                      fx * (1.0 + x * x * iz2), -fx * y * iz], -1)
    jv = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1.0 + y * y * iz2),
                      fy * x * y * iz2, fy * x * iz], -1)
    return torch.stack([ju, jv], 1)


def _huber_weight(chi2, delta):
    """Huber IRLS weight on the chi^2 (g2o ``RobustKernelHuber``)."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def _left_update(dx: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """``exp(dx) @ T`` per pose."""
    return _matmul3(se3_exp(dx), poses)


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor  # [4, 4]
    inliers: torch.Tensor  # [M] bool
    chi2: torch.Tensor  # [M]
    n_inliers: torch.Tensor  # [] int


def pose_optimization(
    T_init: torch.Tensor,
    world: torch.Tensor,  # [M, 3]
    obs_uv: torch.Tensor,  # [M, 2]
    inv_sigma2: torch.Tensor,  # [M]
    valid: torch.Tensor,  # [M] bool
    cam: Camera,
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-4,
    obs_ur: Optional[torch.Tensor] = None,  # [M] right-image u (<0 = mono obs)
    bf: float = 0.0,
) -> PoseOptResult:
    """Motion-only BA with the reference's 4x10 rounds and chi^2 re-gating
    between rounds (``src/Optimizer.cc:239-452``). Observations with
    ``obs_ur >= 0`` are 3-DoF stereo edges [u, v, uR] with uR = u - bf / z
    and the stereo thresholds (``EdgeStereoSE3ProjectXYZOnlyPose``)."""
    M = world.shape[0]
    dev = world.device
    if obs_ur is None:
        obs_ur = torch.full((M,), -1.0, dtype=torch.float32, device=dev)
    is_stereo = obs_ur >= 0.0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    huber = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    eye6 = torch.eye(6, device=dev)

    def residual3(T):
        r2, xc = _project_residual(T, world, obs_uv, cam)
        z = torch.clamp(xc[:, 2], min=1e-6)
        uR_pred = (cam.fx * xc[:, 0] / z + cam.cx) - bf / z
        r_ur = torch.where(is_stereo, uR_pred - obs_ur, torch.zeros_like(z))
        r = torch.cat([r2, r_ur[:, None]], dim=-1)
        # f32 overflow guard: behind-camera points would blow r^2 to inf.
        return torch.clamp(r, -1e4, 1e4), xc

    def jacobian3(xc):
        J2 = _pose_jacobian(xc, cam)
        x, y, z = xc[:, 0], xc[:, 1], torch.clamp(xc[:, 2], min=1e-2)
        iz2 = 1.0 / (z * z)
        zero = torch.zeros_like(z)
        dz = torch.stack([zero, zero, torch.ones_like(z), y, -x, zero], -1)
        jur = J2[:, 0, :] + bf * iz2[:, None] * dz
        jur = torch.where(is_stereo[:, None], jur, torch.zeros_like(jur))
        return torch.cat([J2, jur[:, None, :]], dim=1)

    def chi2_of(T):
        r, _ = residual3(T)
        return inv_sigma2 * (r * r).sum(-1)

    T = T_init
    inliers = torch.ones(M, dtype=torch.bool, device=dev)
    for _ in range(rounds):
        for _ in range(iters_per_round):
            r, xc = residual3(T)
            chi2 = inv_sigma2 * (r * r).sum(-1)
            w = inv_sigma2 * _huber_weight(chi2, huber)
            w = torch.where(valid & inliers & (xc[:, 2] > 1e-2), w, torch.zeros_like(w))
            J = jacobian3(xc)
            JtW = J * w[:, None, None]
            H = _outer_sum(JtW, J).sum(0) + damping * eye6
            b = _rows_dot(JtW, r).sum(0)
            T = _matmul3(se3_exp(-_solve(H, b)), T)
        inliers = chi2_of(T) <= chi2_th
    chi2 = chi2_of(T)
    inliers = valid & (chi2 <= chi2_th)
    return PoseOptResult(T_cw=T, inliers=inliers, chi2=chi2, n_inliers=inliers.sum())


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE3 adjoint ``[..., 6, 6]`` for twists [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, _matmul3(skew(t), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def pose_graph_optimization(
    poses: torch.Tensor,  # [K, 4, 4] T_cw
    edge_i: torch.Tensor,  # [E] int
    edge_j: torch.Tensor,  # [E] int
    rel_ij: torch.Tensor,  # [E, 4, 4] measured T_i_cw @ T_j_cw^{-1}
    edge_w: torch.Tensor,  # [E]
    fixed_mask: torch.Tensor,  # [K] bool
    iters: int = 20,
    damping: float = 1e-3,
) -> torch.Tensor:
    """SE3 pose-graph optimization, the fixed-scale ``OptimizeEssentialGraph``.

    Residual per edge ``r = log(rel_ij^{-1} T_i T_j^{-1})``; batched
    per-node 6x6 Gauss-Seidel with the left-perturbation Jacobians at
    r -> 0, ``J_i = Ad(rel_ij^{-1})`` and ``J_j = -I``, half steps."""
    K = poses.shape[0]
    dev = poses.device
    ei, ej = edge_i.long(), edge_j.long()
    rel_inv = invert_se3(rel_ij)
    A = _adjoint(rel_inv)  # [E, 6, 6], constant across sweeps
    AtA = _matmul3(A.transpose(-1, -2), A)
    I6 = torch.eye(6, device=dev)
    seg = Segments(torch.cat([ei, ej]), K)
    wE = edge_w[:, None, None]
    H = seg.sum(torch.cat([wE * AtA, wE * I6.expand_as(AtA)])) + damping * I6 + 1e-6 * I6
    w = edge_w[:, None]
    for _ in range(iters):
        err = _matmul3(rel_inv, _matmul3(poses[ei], invert_se3(poses[ej])))
        r = se3_log(err)
        Atr = _matvec(A.transpose(-1, -2), r)
        b = seg.sum(torch.cat([w * Atr, -w * r]))
        dx = -_solve(H, b)
        dx = torch.where(fixed_mask[:, None], torch.zeros_like(dx), 0.5 * dx)
        poses = _left_update(dx, poses)
    return poses


def sim3_pose_graph_optimization(
    poses: torch.Tensor,  # [K, 4, 4] T_cw (SE3)
    log_scales: torch.Tensor,  # [K] per-node log-scale (0 = metric)
    edge_i: torch.Tensor,  # [E] int
    edge_j: torch.Tensor,  # [E] int
    rel_ij: torch.Tensor,  # [E, 4, 4] measured SE3 part of S_i S_j^{-1}
    rel_ls: torch.Tensor,  # [E] measured log-scale part
    edge_w: torch.Tensor,  # [E]
    fixed_mask: torch.Tensor,  # [K] bool
    iters: int = 50,
    damping: float = 1e-3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """7-DoF Sim3 essential-graph optimization (``OptimizeEssentialGraph``).

    A node is ``S = (s, R, t): x -> s R x + t``, an SE3 matrix plus a
    log-scale; per edge ``E = S_rel^{-1} S_i S_j^{-1}`` with residual
    ``[se3_log(R_E, t_E), log s_E]``, ``J_i = Ad_sim3(rel^{-1})`` and
    ``J_j = -I7``. Each iteration solves the global damped ``[7K, 7K]``
    normal equations (the chain then converges in a few iterations where
    per-node sweeps propagate one hop each). Returns (poses', log_scales');
    callers absorb the scale as ``T = [R, t / s]``."""
    K = poses.shape[0]
    E = edge_i.shape[0]
    dev = poses.device
    ei, ej = edge_i.long(), edge_j.long()

    def compose(sa, Ra, ta, sb, Rb, tb):
        return sa * sb, _matmul3(Ra, Rb), sa[..., None] * _matvec(Ra, tb) + ta

    def inverse(s, R, t):
        Rt = R.transpose(-1, -2)
        return 1.0 / s, Rt, -(1.0 / s)[..., None] * _matvec(Rt, t)

    sr, Rr, tr = inverse(torch.exp(rel_ls), rel_ij[:, :3, :3], rel_ij[:, :3, 3])
    A = torch.zeros((E, 7, 7), device=dev)
    A[:, 0:3, 0:3] = sr[:, None, None] * Rr
    A[:, 0:3, 3:6] = _matmul3(skew(tr), Rr)
    A[:, 0:3, 6] = -tr
    A[:, 3:6, 3:6] = Rr
    A[:, 6, 6] = 1.0
    At = A.transpose(1, 2)
    AtA = _matmul3(At, A)
    I7 = torch.eye(7, device=dev)
    free = (~fixed_mask).to(torch.float32)
    wE = edge_w[:, None, None]
    pair = Segments(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]), K * K)
    Hb = pair.sum(torch.cat([wE * AtA, wE * I7.expand_as(AtA), -wE * At, -wE * A]))
    Hb = Hb.view(K, K, 7, 7) * (free[:, None, None, None] * free[None, :, None, None])
    H = Hb.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
    H = H + torch.diag(fixed_mask.to(torch.float32).repeat_interleave(7))
    H = H + (damping + 1e-6) * torch.eye(7 * K, device=dev)
    seg = Segments(torch.cat([ei, ej]), K)
    we = edge_w[:, None]
    ls = log_scales
    for _ in range(iters):
        si, sj = torch.exp(ls[ei]), torch.exp(ls[ej])
        Pi, Pj = poses[ei], poses[ej]
        sji, Rji, tji = inverse(sj, Pj[:, :3, :3], Pj[:, :3, 3])
        s1, R1, t1 = compose(si, Pi[:, :3, :3], Pi[:, :3, 3], sji, Rji, tji)
        sE, RE, tE = compose(sr, Rr, tr, s1, R1, t1)
        TE = torch.zeros((E, 4, 4), device=dev)
        TE[:, :3, :3] = RE
        TE[:, :3, 3] = tE
        TE[:, 3, 3] = 1.0
        r7 = torch.cat([se3_log(TE), torch.log(torch.clamp(sE, min=1e-12))[:, None]], dim=1)
        b = seg.sum(torch.cat([we * _matvec(At, r7), -we * r7]))
        bf = (b * free[:, None]).reshape(-1)
        dx = -_solve(H, bf).reshape(K, 7)
        dx = torch.where(fixed_mask[:, None], torch.zeros_like(dx), dx)
        # Left Sim3 retraction: (s, R, t) <- (s_e s, R_e R, s_e R_e t + t_e).
        Te = se3_exp(dx[:, :6])
        se = torch.exp(dx[:, 6])
        Rn = _matmul3(Te[:, :3, :3], poses[:, :3, :3])
        tn = se[:, None] * _matvec(Te[:, :3, :3], poses[:, :3, 3]) + Te[:, :3, 3]
        poses = torch.zeros_like(poses)
        poses[:, :3, :3] = Rn
        poses[:, :3, 3] = tn
        poses[:, 3, 3] = 1.0
        ls = ls + dx[:, 6]
    return poses, ls


class LocalBAResult(NamedTuple):
    poses: torch.Tensor  # [K, 4, 4]
    points: torch.Tensor  # [P, 3]
    inlier_obs: torch.Tensor  # [O] bool


def local_bundle_adjustment(
    poses: torch.Tensor,  # [K, 4, 4] T_cw
    points: torch.Tensor,  # [P, 3]
    obs_kf: torch.Tensor,  # [O] observation -> keyframe index
    obs_pt: torch.Tensor,  # [O] observation -> point index
    obs_uv: torch.Tensor,  # [O, 2]
    obs_inv_sigma2: torch.Tensor,  # [O]
    obs_valid: torch.Tensor,  # [O] bool
    cam: Camera,
    fixed_mask: Optional[torch.Tensor] = None,  # [K] bool poses held fixed
    outer_iters: int = 5,
    damping: float = 1e-3,
) -> LocalBAResult:
    """Local BA by batched block-coordinate Gauss-Seidel: each outer
    iteration a closed-form Huber-robust 3x3 update per point with all its
    observations, then a 6x6 update per pose on the refreshed residuals;
    the chi^2 gate classifies observations only at the end (g2o's robust
    kernel bounds outliers during the sweeps)."""
    K, P = poses.shape[0], points.shape[0]
    dev = poses.device
    if fixed_mask is None:
        fixed_mask = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed_mask[0] = True
    # f32 overflow guards: clip residuals, weight behind-camera observations
    # out and bound each step (a runaway low-parallax point can push r^2
    # past the f32 range).
    R_CLIP = 1e4  # px
    MAX_DX = 1.0  # m per sweep per point
    MAX_DXI = 0.5  # rad / m per sweep per pose
    okf, opt = obs_kf.long(), obs_pt.long()
    seg_p = Segments(opt, P)
    seg_k = Segments(okf, K)
    I3 = torch.eye(3, device=dev)
    I6 = torch.eye(6, device=dev)

    def residuals(xc):
        in_front = xc[:, 2] > 1e-2
        z = torch.clamp(xc[:, 2], min=1e-2)
        u = cam.fx * xc[:, 0] / z + cam.cx
        v = cam.fy * xc[:, 1] / z + cam.cy
        r = torch.clamp(torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1]], -1), -R_CLIP, R_CLIP)
        chi2 = obs_inv_sigma2 * (r * r).sum(-1)
        w = obs_inv_sigma2 * _huber_weight(chi2, HUBER_MONO)
        return r, torch.where(obs_valid & in_front, w, torch.zeros_like(w)), z

    def damped(Hs, n):
        diag = torch.diagonal(Hs, dim1=-2, dim2=-1).max(dim=-1).values
        return Hs + (damping * torch.clamp(diag, min=1.0))[:, None, None] * n

    for _ in range(outer_iters):
        T_o = poses[okf]
        R_o, t_o = T_o[:, :3, :3], T_o[:, :3, 3]
        xc = _matvec(R_o, points[opt]) + t_o
        r, w, z = residuals(xc)
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(z)
        Jp = torch.stack([
            torch.stack([cam.fx * iz, zero, -cam.fx * xc[:, 0] * iz2], -1),
            torch.stack([zero, cam.fy * iz, -cam.fy * xc[:, 1] * iz2], -1),
        ], 1)
        Jx = _matmul3(Jp, R_o)  # d r / d X_world [O, 2, 3]
        JxW = Jx * w[:, None, None]
        Hp = damped(seg_p.sum(_outer_sum(JxW, Jx)), I3)
        bp = seg_p.sum(_rows_dot(JxW, r))
        dX = -_solve(Hp, bp)
        nrm = torch.linalg.norm(dX, dim=-1, keepdim=True)
        dX = dX * torch.clamp(MAX_DX / torch.clamp(nrm, min=1e-9), max=1.0)
        seen = seg_p.sum(w) > 0
        points = points + torch.where(seen[:, None], dX, torch.zeros_like(dX))

        xc = _matvec(R_o, points[opt]) + t_o
        r, w, _ = residuals(xc)
        Jse = _pose_jacobian(xc, cam)
        JseW = Jse * w[:, None, None]
        Hk = damped(seg_k.sum(_outer_sum(JseW, Jse)), I6)
        bk = seg_k.sum(_rows_dot(JseW, r))
        dxi = -_solve(Hk, bk)
        nrmx = torch.linalg.norm(dxi, dim=-1, keepdim=True)
        dxi = dxi * torch.clamp(MAX_DXI / torch.clamp(nrmx, min=1e-9), max=1.0)
        dxi = torch.where(fixed_mask[:, None], torch.zeros_like(dxi), dxi)
        poses = _left_update(dxi, poses)

    # Final observation gate (the reference removes chi2 > 5.991 edges).
    T_o = poses[okf]
    xc = _matvec(T_o[:, :3, :3], points[opt]) + T_o[:, :3, 3]
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = cam.fx * xc[:, 0] / z + cam.cx
    v = cam.fy * xc[:, 1] / z + cam.cy
    r = torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1]], -1)
    chi2 = obs_inv_sigma2 * (r * r).sum(-1)
    return LocalBAResult(poses=poses, points=points,
                         inlier_obs=obs_valid & (chi2 <= CHI2_MONO) & (xc[:, 2] > 0))
