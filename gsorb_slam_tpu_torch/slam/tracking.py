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
every binning episode, as in the JAX package). With K1 or K7 on CUDA
tensors (:func:`graph_path`) the rest of the iteration (the pose chain, its
autograd, the feature term and the pose Adam step) replays as three CUDA
graphs around the eager fused kernel (``slam/track_graph.py``, on the
port's one replay mechanism, ``utils/cuda_graphs.py``, which the mapping
loop shares); paired tracking and the tile-sharded ``parallel.tracking``
run the loop eagerly. On CPU tensors the same loop runs their plain
versions, eagerly. Tile bins are built from the initial pose and rebuilt
at the ``rebin_iters`` iterations (``dilate_px`` covers the drift in
between). With ``early_stop_delta <= 0`` the loop never waits for the
device; otherwise each iteration reads the loss on the host to decide the
break.

Spans (``utils/trace.py``): ``track.bins`` for each binning episode,
``track.iter`` for each iteration. Counters: ``track_graph_captures``
(captures of the three graphs) and ``track_graph_replays`` (iterations
replayed).
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
from gsorb_slam_tpu_torch.slam.track_graph import TrackGraph, frame_graph
from gsorb_slam_tpu_torch.splat.gaussians import (
    GaussianMap,
    PoseState,
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


def graph_path(gm: GaussianMap, rcfg: RasterConfig) -> bool:
    """Whether :func:`track_frame` replays its iterations as CUDA graphs
    (``slam/track_graph.py``): on CUDA tensors with square tiles. CPU
    tensors and paired tracking (K8) run the eager loop."""
    return gm.means.is_cuda and not rcfg.paired


class _Forward(NamedTuple):
    """An iteration's forward, as its backward takes it."""

    q: torch.Tensor  # [4] the pose leaves
    t: torch.Tensor  # [3]
    screen: torch.Tensor  # [T, 16, cap] K2f's screen pack
    chi2_l: torch.Tensor | None  # [] the weighted feature term (None without features)


@dataclasses.dataclass
class StepState:
    """The pose loop's state between iterations: the pose and its Adam
    moments, the best-loss pose and loss, the last loss and the early-stop
    flag of the last step."""

    ps: PoseState
    best_q: torch.Tensor  # [4]
    best_t: torch.Tensor  # [3]
    best_loss: torch.Tensor  # []
    last_loss: torch.Tensor  # []
    stop: torch.Tensor  # [] bool: |last loss - loss| < early_stop_delta

    @classmethod
    def start(cls, quat: torch.Tensor, trans: torch.Tensor) -> "StepState":
        ps = init_pose_state(quat, trans)
        dev = ps.quat.device
        return cls(ps=ps, best_q=ps.quat, best_t=ps.trans,
                   best_loss=torch.full((), float("inf"), device=dev),
                   last_loss=torch.zeros((), device=dev),
                   stop=torch.zeros((), dtype=torch.bool, device=dev))

    def tensors(self) -> list[torch.Tensor]:
        """The pose state's tensors in field order, then the others'."""
        ps = [getattr(self.ps, f.name) for f in dataclasses.fields(self.ps)]
        return ps + [self.best_q, self.best_t, self.best_loss, self.last_loss, self.stop]

    def clone(self) -> "StepState":
        """A copy in fresh tensors (no two fields share storage)."""
        x = [t.clone() for t in self.tensors()]
        n = len(dataclasses.fields(self.ps))
        return StepState(PoseState(*x[:n]), *x[n:])

    def copy_(self, other: "StepState") -> None:
        """Write ``other``'s values into this state's tensors."""
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)


def pose_step(st: StepState, loss: torch.Tensor, g_quat: torch.Tensor,
              g_trans: torch.Tensor, tcfg: TrackingConfig) -> StepState:
    """The loop's update after an iteration's loss and pose gradients: keep
    the pose if its loss is finite and the best so far, flag ``|last loss -
    loss| < early_stop_delta``, take the pose Adam step; ``loss`` becomes the
    last loss."""
    improved = torch.isfinite(loss) & (loss < st.best_loss)
    return StepState(
        ps=pose_adam_step(st.ps, g_quat, g_trans, tcfg),
        best_q=torch.where(improved, st.ps.quat, st.best_q),
        best_t=torch.where(improved, st.ps.trans, st.best_t),
        best_loss=torch.where(improved, loss, st.best_loss),
        last_loss=loss,
        stop=(st.last_loss - loss).abs() < tcfg.early_stop_delta,
    )


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

    Runs on the device of the map's tensors; on the :func:`graph_path` each
    iteration replays CUDA graphs of the eager code, with the eager loop's
    results bit for bit. ``rcfg`` is the tracking view (see
    :func:`tracking_raster_config`); ``bins``, if given, are its bins at
    ``T_cw_init`` in row-major tile order (paired tracking reorders them).
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

    def operands(T_cw: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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

    def forward(quat, trans, inliers, raw, m: FeatureMatches) -> _Forward:
        """The pose chain, K2f and the feature term, differentiable w.r.t.
        the pose."""
        q = quat.detach().requires_grad_(True)
        t = trans.detach().requires_grad_(True)
        with torch.enable_grad():
            T_cw = pose_to_matrix(q, t)
            screen = preprocess_instances_kernel(raw, rt_from_matrix(T_cw), cam, scale_modifier)
            chi2_l = None
            if use_features:
                chi2 = reprojection_chi2(T_cw, m, cam)
                chi2 = torch.where(m.valid & inliers, chi2, torch.zeros_like(chi2))
                chi2_l = tcfg.feature_weight * chi2.sum()
        return _Forward(q, t, screen, chi2_l)

    def loss_grad(screen, counts, gt4, out=None):
        """The fused kernel (K1, K7 or K8): ``(im_w * image_l1, depth_w *
        depth_l1, d_screen)``, ``d_screen`` written into ``out`` if given."""
        if paired:
            return tracking_loss_grad_paired(
                screen.detach(), counts, gt4, cam, rcfg,
                tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth, tile_ids=perm,
            )
        return tracking_loss_grad(
            screen.detach(), counts, gt4, cam, rcfg,
            tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth, out=out,
        )

    def backward(fwd: _Forward, loss, d_screen):
        """Autograd from the screen cotangent (K2b) and the feature term to
        the pose -> ``(loss, g_quat, g_trans)``."""
        with torch.enable_grad():
            if fwd.chi2_l is None:
                torch.autograd.backward(fwd.screen, d_screen)
            else:
                torch.autograd.backward([fwd.screen, fwd.chi2_l],
                                        [d_screen, torch.ones_like(fwd.chi2_l)])
                loss = loss + fwd.chi2_l.detach()
        return loss, fwd.q.grad, fwd.t.grad

    if not graph_path(gm, rcfg):
        def value_and_grad(quat, trans, inliers, raw, counts, gt4):
            fwd = forward(quat, trans, inliers, raw, matches)
            img_l1, dep_l1, d_screen = loss_grad(fwd.screen, counts, gt4)
            return backward(fwd, img_l1 + dep_l1, d_screen)

        return pose_loop(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, operands,
                         value_and_grad)

    graph = None

    def episode(T_cw: torch.Tensor | None) -> tuple[TrackGraph]:
        """The episode's operands, copied into the graph's buffers."""
        nonlocal graph
        raw, counts, gt4 = operands(T_cw)
        if graph is None:
            # The graph bodies look up the pose chain, K2f, the feature term
            # and the step by their module-level names when they run, so a
            # patched function is what gets captured; they are in the key.
            observed = (cam, tcfg, rcfg, scale_modifier, pose_to_matrix, rt_from_matrix,
                        preprocess_instances_kernel, reprojection_chi2, pose_step,
                        pose_adam_step)
            graph = frame_graph(
                raw, counts, gt4, matches, use_features, observed,
                fwd_fn=lambda g: forward(g.state.ps.quat, g.state.ps.trans, g.inliers, g.raw,
                                         g.matches),
                bwd_fn=lambda g, fwd: backward(fwd, g.base_loss, g.d_screen),
                step_fn=lambda g, loss, gq, gt_: g.state.copy_(
                    pose_step(g.state, loss, gq, gt_, tcfg)),
            )
        graph.load(raw, counts, gt4)
        return (graph,)

    def graph_value_and_grad(quat, trans, inliers, g: TrackGraph):
        """``G_fwd``, the fused kernel (eager, into the graph's cotangent
        buffer; its loss rows added into ``base_loss``) and ``G_bwd``; the
        pose and inlier gate handed in are ``g``'s buffers, which the
        graphs read."""
        fwd = g.forward()
        img_l1, dep_l1, _ = loss_grad(fwd.screen, g.counts, g.gt4, out=g.d_screen)
        torch.add(img_l1, dep_l1, out=g.base_loss)
        return g.backward()

    return pose_loop(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, episode,
                     graph_value_and_grad)


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
    the best-loss pose and stops early on ``early_stop_delta``. Operands
    that are one :class:`TrackGraph` (``track_frame`` on its graph path)
    hold the loop's state in the graph's buffers, and each step replays
    its ``G_step``."""
    num_iters = int(num_iters or tcfg.num_iters)
    if rebin_iters is None:
        rebin_iters = tcfg.rebin_iters
    if rebin_iters is None:
        rebin_iters = default_rebin_iters(num_iters)
    rebin_iters = tuple(r for r in rebin_iters if 0 < r < num_iters)
    quat0, trans0 = matrix_to_pose(T_cw_init.detach())
    with torch.no_grad(), trace.span("track.bins"):
        operands = episode(None)
    graph = operands[0] if isinstance(operands[0], TrackGraph) else None
    with torch.no_grad():
        st = StepState.start(quat0, trans0)
        inliers = torch.ones_like(matches.valid)
        if graph is not None:
            st, inliers = graph.start(st, inliers, matches)

    regate_iter = num_iters // 2  # feature_clear (src/Render.cc:1052)
    it = 0
    n_applied = 0
    for i, seg_end in enumerate(list(sorted(rebin_iters)) + [num_iters]):
        if i > 0 and it < num_iters:
            # Rebin at the segment boundary, at the current pose.
            with torch.no_grad(), trace.span("track.bins"):
                operands = episode(pose_to_matrix(st.ps.quat, st.ps.trans))
        while it < seg_end:
            with trace.span("track.iter"):
                loss, gq, gt_ = value_and_grad(st.ps.quat, st.ps.trans, inliers, *operands)
                with torch.no_grad():
                    if it == regate_iter:  # halfway inlier re-gate at the current pose
                        chi2_now = reprojection_chi2(pose_to_matrix(st.ps.quat, st.ps.trans),
                                                     matches, cam)
                        inliers.copy_(chi2_now < CHI2_INLIER)
                    if graph is None:
                        st = pose_step(st, loss, gq, gt_, tcfg)
                    else:
                        graph.step()
                    converged = (
                        tcfg.early_stop_delta > 0.0 and trace.wait(bool, st.stop)
                    )
                    it = num_iters if converged else it + 1
                    n_applied += 1

    with torch.no_grad():
        T_best = pose_to_matrix(st.best_q, st.best_t)
        return TrackResult(
            T_cw=T_best,
            loss=st.best_loss.clone(),
            n_iters=torch.tensor(n_applied, dtype=torch.int32, device=quat0.device),
            chi2=reprojection_chi2(T_best, matches, cam),
            inliers=inliers & matches.valid,
        )
