"""Multi-device tracking: the fused pose-refinement iteration sharded by
tile (counterpart of ``gsorb_slam_tpu/parallel/tracking.py``).

- The Gaussian map and the pose state are replicated.
- The per-tile instance pack, counts and gt tiles are sharded over the
  mesh's ranks round-robin (strided), so spatially correlated instance
  counts balance: rank r holds the rows ``[r Tl, (r + 1) Tl)`` of
  :func:`strided_tile_perm`'s permutation.
- Each rank runs the fused tracking kernel (K1, or K7 under ``exact_stop``)
  on its strip; the kernel's ``tile_ids`` operand maps its rows to their
  global tile origins.
- One ``all_reduce`` per iteration sums the two loss terms and the 7-dof
  pose gradient: O(1) bytes per step, not O(pixels).

The feature chi^2 term and the pose Adam step run replicated, so the
replicas stay bitwise equal, as in the mapping path (``parallel/mesh.py``).
Rebinning episodes segment the loop as in ``slam/tracking.track_frame``
(both run ``slam.tracking.pose_loop``): binning runs replicated between
segments, then each rank packs its strip.

The projection is the kernel pair K2f / K2b
(``preprocess_instances_kernel``), as in ``track_frame``; the JAX package
projects with its XLA ``preprocess_instances`` here, which computes the same
function. Each iteration therefore launches K2f, K1 (or K7) and K2b once.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
from gsorb_slam_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from gsorb_slam_tpu_torch.raster.binning import TileBins, bin_gaussians
from gsorb_slam_tpu_torch.raster.blend_kernels import tile_gt_images, tracking_loss_grad
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
from gsorb_slam_tpu_torch.raster.preprocess import preprocess
from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.slam.tracking import (
    FeatureMatches,
    TrackResult,
    pose_loop,
    reprojection_chi2,
)
from gsorb_slam_tpu_torch.splat.gaussians import GaussianMap


def strided_tile_perm(
    n_tiles: int, n_dev: int, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Round-robin tile assignment under contiguous-block sharding: sharded
    row ``s Tl + j`` (rank s, local row j) holds global tile ``j n_dev + s``.
    Returns ``(perm int32, is_pad bool)`` of length ``n_tiles`` rounded up to
    a multiple of ``n_dev``; pad rows repeat tile 0 and are flagged so their
    instance counts can be zeroed."""
    Tp = -(-n_tiles // n_dev) * n_dev
    perm = torch.arange(Tp, dtype=torch.int32, device=device).reshape(Tp // n_dev, n_dev)
    perm = perm.T.reshape(-1)
    is_pad = perm >= n_tiles
    return torch.where(is_pad, torch.zeros_like(perm), perm), is_pad


def parallel_track_frame(
    gm: GaussianMap,
    T_cw_init: torch.Tensor,
    gt_color: torch.Tensor,  # [H, W, 3]
    gt_depth: torch.Tensor,  # [H, W], 0 = invalid
    matches: FeatureMatches,
    cam: Camera,
    tcfg: TrackingConfig,
    rcfg: RasterConfig,
    mesh: Mesh,
    num_iters: int | None = None,
    scale_modifier: float = 1.0,
    rebin_iters: tuple[int, ...] | None = None,
) -> TrackResult:
    """Tile-sharded twin of ``slam.tracking.track_frame`` (square tiles; a
    paired view raises). Every rank calls it with the same arguments and
    gets the same result; it matches the single-device loop up to the order
    of the cross-rank sum, and bit for bit on one rank."""
    if rcfg.paired:
        raise ValueError("the tile-sharded tracking shards square tiles: strip paired first")
    gt4 = tile_gt_images(gt_color, gt_depth, cam, rcfg)  # [T, 4, px]
    perm, is_pad = strided_tile_perm(gt4.shape[0], mesh.size, device=gt4.device)
    n_local = perm.numel() // mesh.size
    mine = slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)
    tids = perm[mine].contiguous()
    rows = tids.long()
    pad = is_pad[mine]
    gt4_l = gt4[rows].contiguous()

    def strip(T_cw: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's strip of the raw pack and its counts (0 on pad rows)
        from bins at ``T_cw`` (None: the initial pose)."""
        prep = preprocess(
            gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales, gm.active,
            (T_cw_init if T_cw is None else T_cw).detach(), cam, scale_modifier,
        )
        b = bin_gaussians(prep, cam, rcfg)
        counts = torch.where(pad, torch.zeros_like(b.counts[rows]), b.counts[rows])
        b = TileBins(indices=b.indices[rows], counts=counts, n_dropped=b.n_dropped)
        return pack_raw_instances(
            gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales, gm.active, b,
        ), counts

    use_features = bool(matches.valid.any())

    def value_and_grad(quat, trans, inliers, raw, counts):
        q = quat.detach().requires_grad_(True)
        t = trans.detach().requires_grad_(True)
        with torch.enable_grad():
            screen = preprocess_instances_kernel(raw, rt_from_matrix(pose_to_matrix(q, t)), cam,
                                                 scale_modifier)
            img_l1, dep_l1, d_screen = tracking_loss_grad(
                screen.detach(), counts, gt4_l, cam, rcfg,
                tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth, tile_ids=tids,
            )
            torch.autograd.backward(screen, d_screen)
        # ONE all_reduce carries the strip's losses and 7-dof gradient.
        buf = all_reduce_sum(torch.cat([img_l1.reshape(1), dep_l1.reshape(1), q.grad, t.grad]),
                             mesh)
        loss, gq, gt_ = buf[0] + buf[1], buf[2:6], buf[6:9]
        if use_features:  # replicated, no collective
            q2 = quat.detach().requires_grad_(True)
            t2 = trans.detach().requires_grad_(True)
            with torch.enable_grad():
                chi2 = reprojection_chi2(pose_to_matrix(q2, t2), matches, cam)
                chi2 = torch.where(matches.valid & inliers, chi2, torch.zeros_like(chi2))
                chi2_l = tcfg.feature_weight * chi2.sum()
                chi2_l.backward()
            loss, gq, gt_ = loss + chi2_l.detach(), gq + q2.grad, gt_ + t2.grad
        return loss, gq, gt_

    return pose_loop(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, strip,
                     value_and_grad)
