"""Tracking-by-rendering: camera pose refinement against the Gaussian map
(counterpart of ``gsorb_slam_tpu/slam/tracking.py``).

Equivalent of ``Render::RenderStartTraking`` (``src/Render.cc:985-1141``):
Adam on an unnormalized quaternion + translation, loss =

    imWeight * maskedSumL1(color) + depthWeight * maskedSumL1(depth)
    + featureWeight * sum(chi^2 ORB reprojection over inliers)

with the pixel mask = rendered-alpha > 0.99 & valid gt depth, the feature
inlier set re-gated once at the halfway iteration (chi^2 < 5.991), the
best-loss pose kept, and early stopping on |dloss| < ``early_stop_delta``.

Each iteration is three kernel launches on CUDA: the per-instance
projection K2f, the fused tracking kernel (blend + loss + cotangents +
backward) and the projection adjoint K2b. The fused kernel is K1 (fast
stop), K7 (``exact_stop=True``) or, with ``paired=True``, K8 over 16x8 rect
tiles in pair-major order (``raster/paired.py``; the pairing is rebuilt at
every binning episode, as in the JAX package). On CPU tensors the same loop
runs their plain versions. Tile bins are built from the initial pose and rebuilt
at the ``rebin_iters`` iterations (``dilate_px`` covers the drift in
between). With ``early_stop_delta <= 0`` the loop never waits for the
device; otherwise each iteration reads the loss on the host to decide the
break.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import TrackingConfig, default_rebin_iters
from gsorb_slam_tpu_torch.core.transforms import matrix_to_pose, pose_to_matrix
from gsorb_slam_tpu_torch.raster.binning import TileBins, bin_gaussians
from gsorb_slam_tpu_torch.raster.blend_kernels import tile_gt_images, tracking_loss_grad
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
from gsorb_slam_tpu_torch.raster.paired import (
    pack_gt_pairs,
    pair_bins,
    tracking_loss_grad_paired,
    tracking_pair_order,
)
from gsorb_slam_tpu_torch.raster.preprocess import preprocess
from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.splat.gaussians import (
    GaussianMap,
    init_pose_state,
    pose_adam_step,
)
from gsorb_slam_tpu_torch.utils import trace

CHI2_INLIER = 5.991  # 95% chi^2 with 2 DoF (src/Render.cc:1081)


class FeatureMatches(NamedTuple):
    """Padded ORB map-point matches for the reprojection term."""

    obs_uv: torch.Tensor  # [M, 2] undistorted pixel observations
    world: torch.Tensor  # [M, 3] matched MapPoint positions
    inv_sigma2: torch.Tensor  # [M] per-octave information weights
    valid: torch.Tensor  # [M] bool padding mask

    @staticmethod
    def empty(m: int = 8, device: torch.device | str = "cuda") -> "FeatureMatches":
        return FeatureMatches(
            obs_uv=torch.zeros((m, 2), device=device),
            world=torch.zeros((m, 3), device=device),
            inv_sigma2=torch.ones((m,), device=device),
            valid=torch.zeros((m,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class TrackResult:
    T_cw: torch.Tensor  # [4, 4] best pose
    loss: torch.Tensor  # [] best loss
    n_iters: torch.Tensor  # [] int32 iterations actually applied
    chi2: torch.Tensor  # [M] final per-match chi^2
    inliers: torch.Tensor  # [M] bool final inlier gate


def tracking_raster_config(rcfg: RasterConfig) -> RasterConfig:
    """The tracking view of a raster config (the JAX System's, ``slam/
    system.py:340-363``): ``track_tile_capacity`` and ``track_chunk`` replace
    the render values where set (the tracking pack and projection are dense
    over the capacity), and ``paired`` bins 16x8 rect tiles (half-height
    tiles; mapping and renders keep the square grid)."""
    if rcfg.track_tile_capacity:
        rcfg = dataclasses.replace(rcfg, tile_capacity=rcfg.track_tile_capacity)
    if rcfg.track_chunk:
        rcfg = dataclasses.replace(rcfg, chunk=rcfg.track_chunk)
    if rcfg.paired:
        if rcfg.exact_stop:
            raise ValueError("paired tracking implements the fast stop rule only")
        rcfg = dataclasses.replace(rcfg, tile_h=rcfg.tile // 2)
    return rcfg


def reprojection_chi2(
    T_cw: torch.Tensor, matches: FeatureMatches, cam: Camera
) -> torch.Tensor:
    """Per-match chi^2 = invSigma2 * ||project(Tcw X) - obs||^2
    (``src/Render.cc:1058-1075``)."""
    R = T_cw[:3, :3]
    xc = (matches.world[:, None, :] * R[None]).sum(-1) + T_cw[:3, 3]  # [M, 3]
    z = xc[:, 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.fx * xc[:, 0] / safe_z + cam.cx
    v = cam.fy * xc[:, 1] / safe_z + cam.cy
    du = u - matches.obs_uv[:, 0]
    dv = v - matches.obs_uv[:, 1]
    return matches.inv_sigma2 * (du * du + dv * dv)


def track_frame(
    gm: GaussianMap,
    T_cw_init: torch.Tensor,
    gt_color: torch.Tensor,  # [H, W, 3]
    gt_depth: torch.Tensor,  # [H, W], 0 = invalid
    matches: FeatureMatches,
    cam: Camera,
    tcfg: TrackingConfig,
    rcfg: RasterConfig,
    num_iters: int | None = None,
    bins: TileBins | None = None,
    scale_modifier: float = 1.0,
    rebin_iters: tuple[int, ...] | None = None,
) -> TrackResult:
    """Optimize the camera pose of one frame against the current map.

    Runs on the device of the map's tensors. ``rcfg`` is the tracking view
    (see :func:`tracking_raster_config`); ``bins``, if given, are its bins
    at ``T_cw_init`` in row-major tile order (paired tracking reorders them).
    ``rebin_iters`` rebuilds the tile bins and instance pack at the current
    pose at those iterations; ``None`` takes the config's, else the
    budget-adaptive default."""

    def build_bins(T_cw: torch.Tensor) -> TileBins:
        prep = preprocess(
            gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
            gm.active, T_cw.detach(), cam, scale_modifier,
        )
        return bin_gaussians(prep, cam, rcfg)

    def build_raw(b: TileBins) -> torch.Tensor:
        return pack_raw_instances(
            gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
            gm.active, b,
        )

    paired = rcfg.paired
    perm = None  # the episode's pairing (paired tracking)
    gt_tiles = None if paired else tile_gt_images(gt_color, gt_depth, cam, rcfg)

    def episode(T_cw: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The pack, counts and gt tiles of the binning episode at ``T_cw``
        (None: the initial pose, or ``bins`` if given); the paired gt follows
        the episode's pairing."""
        nonlocal perm
        b = bins if T_cw is None and bins is not None else build_bins(
            T_cw_init if T_cw is None else T_cw)
        if not paired:
            return build_raw(b), b.counts, gt_tiles
        perm = tracking_pair_order(b, cam, rcfg)
        b = pair_bins(b, perm)
        return build_raw(b), b.counts, pack_gt_pairs(gt_color, gt_depth, cam, rcfg, perm)

    use_features = trace.wait(bool, matches.valid.any())

    def chi2_masked(T_cw: torch.Tensor, inliers: torch.Tensor) -> torch.Tensor:
        chi2 = reprojection_chi2(T_cw, matches, cam)
        return torch.where(matches.valid & inliers, chi2, torch.zeros_like(chi2))

    def value_and_grad(quat, trans, inliers, raw, counts, gt4):
        q = quat.detach().requires_grad_(True)
        t = trans.detach().requires_grad_(True)
        with torch.enable_grad():
            T_cw = pose_to_matrix(q, t)
            screen = preprocess_instances_kernel(raw, rt_from_matrix(T_cw), cam, scale_modifier)
            if paired:
                img_l1, dep_l1, d_screen = tracking_loss_grad_paired(
                    screen.detach(), counts, gt4, cam, rcfg,
                    tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth, tile_ids=perm,
                )
            else:
                img_l1, dep_l1, d_screen = tracking_loss_grad(
                    screen.detach(), counts, gt4, cam, rcfg,
                    tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth,
                )
            loss = img_l1 + dep_l1
            if use_features:
                chi2_l = tcfg.feature_weight * chi2_masked(T_cw, inliers).sum()
                torch.autograd.backward([screen, chi2_l], [d_screen, torch.ones_like(chi2_l)])
                loss = loss + chi2_l.detach()
            else:
                torch.autograd.backward(screen, d_screen)
        return loss, q.grad, t.grad

    return pose_loop(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, episode,
                     value_and_grad)


def pose_loop(
    T_cw_init: torch.Tensor,
    matches: FeatureMatches,
    cam: Camera,
    tcfg: TrackingConfig,
    num_iters: int | None,
    rebin_iters: tuple[int, ...] | None,
    episode,
    value_and_grad,
) -> TrackResult:
    """The pose-Adam loop of :func:`track_frame` and the tile-sharded
    ``parallel.tracking.parallel_track_frame``.

    ``episode(T_cw)`` returns the operands of a binning episode at a pose
    (``None``: the initial one); ``value_and_grad(quat, trans, inliers,
    *operands)`` the loss and its quaternion and translation gradients.
    Rebins at ``rebin_iters`` (``None``: the config's, else the
    budget-adaptive default), re-gates the feature inliers halfway, keeps
    the best-loss pose and stops early on ``early_stop_delta``."""
    num_iters = int(num_iters or tcfg.num_iters)
    if rebin_iters is None:
        rebin_iters = tcfg.rebin_iters
    if rebin_iters is None:
        rebin_iters = default_rebin_iters(num_iters)
    rebin_iters = tuple(r for r in rebin_iters if 0 < r < num_iters)
    quat0, trans0 = matrix_to_pose(T_cw_init.detach())
    ps = init_pose_state(quat0, trans0)
    with torch.no_grad(), trace.span("track.bins"):
        operands = episode(None)

    regate_iter = num_iters // 2  # feature_clear (src/Render.cc:1052)
    inliers = torch.ones_like(matches.valid)
    best_q, best_t = ps.quat, ps.trans
    best_loss = torch.full((), float("inf"), device=quat0.device)
    last_loss = torch.zeros((), device=quat0.device)
    it = 0
    n_applied = 0
    for i, seg_end in enumerate(list(sorted(rebin_iters)) + [num_iters]):
        if i > 0 and it < num_iters:
            # Rebin at the segment boundary, at the current pose.
            with torch.no_grad(), trace.span("track.bins"):
                operands = episode(pose_to_matrix(ps.quat, ps.trans))
        while it < seg_end:
            with trace.span("track.iter"):
                loss, gq, gt_ = value_and_grad(ps.quat, ps.trans, inliers, *operands)
                with torch.no_grad():
                    if it == regate_iter:  # halfway inlier re-gate at the current pose
                        chi2_now = reprojection_chi2(pose_to_matrix(ps.quat, ps.trans), matches,
                                                     cam)
                        inliers = chi2_now < CHI2_INLIER
                    improved = torch.isfinite(loss) & (loss < best_loss)
                    best_q = torch.where(improved, ps.quat, best_q)
                    best_t = torch.where(improved, ps.trans, best_t)
                    best_loss = torch.where(improved, loss, best_loss)
                    converged = (
                        tcfg.early_stop_delta > 0.0
                        and trace.wait(bool, (last_loss - loss).abs() < tcfg.early_stop_delta)
                    )
                    it = num_iters if converged else it + 1
                    ps = pose_adam_step(ps, gq, gt_, tcfg)
                    last_loss = loss
                    n_applied += 1

    with torch.no_grad():
        T_best = pose_to_matrix(best_q, best_t)
        return TrackResult(
            T_cw=T_best,
            loss=best_loss,
            n_iters=torch.tensor(n_applied, dtype=torch.int32, device=quat0.device),
            chi2=reprojection_chi2(T_best, matches, cam),
            inliers=inliers & matches.valid,
        )
