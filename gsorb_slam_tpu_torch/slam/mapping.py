"""Mapping: densification and windowed Gaussian-map optimization
(counterpart of ``gsorb_slam_tpu/slam/mapping.py``).

- :func:`densify_frame` = ``Render::AddGaussian`` + ``ProjectPixel``
  (``src/Render.cc:557-654``): the transmittance / depth-error add mask and
  the backprojection of the chosen pixels into dead map rows.
- :func:`map_window` = ``Render::RenderForFrame`` (``src/Render.cc:402-493``):
  ``Mapping.numIters`` Adam steps, each on a uniformly random frame of the
  optimization window, with the reference's loss mix. One step is
  :func:`map_step`.
- :func:`seed_from_frame` = ``InitGaussianPoint`` (``src/Render.cc:666-707``).

The render always takes the flat-chunk path
(:func:`~gsorb_slam_tpu_torch.raster.flat_kernels.render_flat`): K4 / K5 on
CUDA tensors, their plain versions on CPU tensors. Each window frame's chunk
layout and pack residuals are built once per :func:`map_window` call and
reused by every iteration on that frame. The iteration loop runs on the host
(one Python iteration per Adam step); the frame of each step is drawn from
a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.camera import Camera, backproject, pixel_grid
from gsorb_slam_tpu_torch.core.config import MappingConfig
from gsorb_slam_tpu_torch.core.transforms import invert_se3, transform_points
from gsorb_slam_tpu_torch.ops.losses import l1_mapping, ssim
from gsorb_slam_tpu_torch.raster.binning import ChunkBins, TileBins, chunk_layout, tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import PackAux, flat_pack_grad_aux
from gsorb_slam_tpu_torch.raster.flat_kernels import render_flat
from gsorb_slam_tpu_torch.raster.preprocess import preprocess
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput
from gsorb_slam_tpu_torch.splat.gaussians import (
    PARAM_NAMES,
    GaussianMap,
    adam_step,
    add_points,
    map_learning_rates,
    prune_low_opacity,
)


@dataclasses.dataclass
class WindowFrames:
    """Stacked optimization-window frames, padded to the window size."""

    colors: torch.Tensor  # [W, H, Wd, 3]
    depths: torch.Tensor  # [W, H, Wd]
    poses: torch.Tensor  # [W, 4, 4] T_cw
    bins_indices: torch.Tensor  # [W, T, cap] int32
    bins_counts: torch.Tensor  # [W, T] int32
    n_frames: int  # live frames (<= W)


@dataclasses.dataclass
class FrameLayout:
    """One window frame's flat-chunk layout and pack-backward residuals."""

    cbins: ChunkBins
    pack_aux: PackAux


def densify_frame(
    gm: GaussianMap,
    out: RenderOutput,
    gt_color: torch.Tensor,
    gt_depth: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    mcfg: MappingConfig,
    sat_tiles: torch.Tensor | None = None,  # [T] bool: bin-saturated tiles
    rcfg: RasterConfig | None = None,  # maps sat_tiles to pixels
) -> tuple[GaussianMap, torch.Tensor]:
    """Add splats where the render disagrees with the sensor; returns (new
    map, number added).

    The mask is ``Render::AddGaussian``'s (``src/Render.cc:557-594``): c1 =
    not yet opaque, rendered dark and a depth error above mean + madienMul *
    median of the small errors; c2 = alpha < 0.8. Two bounded-capacity
    guards: the pixels of ``sat_tiles`` are left out, and at most
    ``mcfg.max_adds_per_frame`` pixels are added, worst first (depth error
    + alpha deficit; ties keep the lower pixel index)."""
    gray = (out.color[..., 0] * 299.0 + out.color[..., 1] * 587.0
            + out.color[..., 2] * 114.0) / 1000.0
    black = gray < (50.0 / 255.0)

    diff = (gt_depth - out.depth).abs()
    err_mask = (diff < 0.05) & (gt_depth > 0) & (out.depth > 0)
    masked = torch.where(err_mask, diff, torch.full_like(diff, float("nan"))).reshape(-1)
    mean_val = torch.nanmean(masked)
    # The median of an even count averages the two middle values, as
    # jnp.nanmedian does (torch.nanmedian returns the lower one).
    med_val = torch.nanquantile(masked, 0.5, interpolation="linear")
    th = torch.clamp(mean_val + mcfg.madien_mul * med_val, min=0.01)
    th = torch.where(torch.isfinite(th), th, torch.full_like(th, 0.01))

    c1 = ~(out.alpha > 0.99) & black & (diff > th)
    c2 = out.alpha < 0.8
    add_mask = (c1 | c2) & (gt_depth > 0)

    if sat_tiles is not None and rcfg is not None:
        ty, tx = tile_grid_shape(cam, rcfg)
        tsx, tsy = rcfg.tile_w_px, rcfg.tile_h_px
        sat_px = sat_tiles.reshape(ty, tx)[:, None, :, None].expand(ty, tsy, tx, tsx)
        sat_px = sat_px.reshape(ty * tsy, tx * tsx)[: cam.height, : cam.width]
        add_mask = add_mask & ~sat_px

    max_adds = int(getattr(mcfg, "max_adds_per_frame", 0) or 0)
    if max_adds and max_adds < add_mask.numel():
        # Worst-first budget: exactly the max_adds highest scores; a stable
        # sort keeps the lower index first among ties (lax.top_k's order).
        score = torch.where(
            add_mask, diff + torch.clamp(0.8 - out.alpha, min=0.0),
            torch.full_like(diff, float("-inf")),
        ).reshape(-1)
        top = torch.sort(score, descending=True, stable=True).indices[:max_adds]
        keep = torch.zeros_like(score, dtype=torch.bool)
        keep[top] = True
        add_mask = add_mask & keep.reshape(add_mask.shape)

    uv = pixel_grid(cam, device=gt_depth.device)
    pts_cam = backproject(cam, uv, gt_depth)
    pts_world = transform_points(invert_se3(T_cw), pts_cam.reshape(-1, 3))
    n_before = gm.count
    gm = add_points(
        gm, pts_world, gt_color.reshape(-1, 3), gt_depth.reshape(-1), add_mask.reshape(-1),
        cam.fx, cam.fy, init_scalar_method=mcfg.init_scalar_method,
    )
    max_z = torch.maximum(gm.max_z, torch.where(add_mask, gt_depth, torch.zeros_like(gt_depth)).max())
    gm = dataclasses.replace(gm, max_z=max_z)
    return gm, gm.count - n_before


def seed_from_frame(
    gm: GaussianMap,
    gt_color: torch.Tensor,
    gt_depth: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    mcfg: MappingConfig,
    stride: int = 1,
) -> GaussianMap:
    """Dense per-pixel seeding (``InitGaussianPoint``,
    ``src/Render.cc:666-707``); ``stride`` subsamples the pixel grid."""
    uv = pixel_grid(cam, device=gt_depth.device)[::stride, ::stride]
    depth = gt_depth[::stride, ::stride]
    color = gt_color[::stride, ::stride]
    pts_cam = backproject(cam, uv, depth)
    pts_world = transform_points(invert_se3(T_cw), pts_cam.reshape(-1, 3))
    gm = add_points(
        gm, pts_world, color.reshape(-1, 3), depth.reshape(-1), (depth > 0).reshape(-1),
        cam.fx, cam.fy, init_scalar_method=mcfg.init_scalar_method,
    )
    max_z = torch.maximum(gm.max_z, depth.max())
    return dataclasses.replace(gm, max_z=max_z, scene_radius=max_z / mcfg.radius_depth_ratio)


def mapping_loss(
    gm: GaussianMap,
    out: RenderOutput,
    gt_color: torch.Tensor,
    gt_depth: torch.Tensor,
    mcfg: MappingConfig,
    init_mode: bool,
) -> torch.Tensor:
    """The reference's mapping loss (``src/Render.cc:420-483``; the warm-up
    variant of ``InitWorld``, ``:537-541``, with ``init_mode``)."""
    valid = gt_depth > 0
    image_loss = mcfg.lam * l1_mapping(out.color, gt_color)
    if mcfg.lam != 1.0:  # lam = 1, the L1-only loss, skips SSIM's convolutions
        image_loss = image_loss + (1.0 - mcfg.lam) * (1.0 - ssim(out.color, gt_color))
    depth_loss = l1_mapping(out.depth, gt_depth, valid)
    if init_mode:
        surdepth_loss = l1_mapping(out.median_depth, gt_depth, valid)
        return mcfg.im_weight * image_loss + 0.1 * surdepth_loss + mcfg.depth_weight * depth_loss
    surdepth_loss = l1_mapping(out.median_depth, gt_depth, valid & (out.alpha > 0.99))
    # Scale regularizers over splats with any scale beyond 0.1 sceneRadius.
    # The reference's where()[0] yields one entry per exceeding element, so
    # rows count once per exceeding scale (src/Render.cc:464-470).
    scales = torch.exp(gm.log_scales)
    max_scalar = 0.1 * gm.scene_radius
    w_row = (scales > max_scalar).sum(-1).to(torch.float32) * gm.active.to(torch.float32)
    smax = scales.amax(-1)
    smin = scales.amin(-1)
    reg_scalar = (w_row * (smax - max_scalar)).sum()
    reg_long = (w_row * (smax - smin)).sum() / torch.clamp(w_row.sum(), min=1.0)
    return (
        mcfg.im_weight * image_loss
        + mcfg.depth_weight * depth_loss
        + mcfg.sur_depth_weight * surdepth_loss
        + mcfg.reg_long_weight * reg_long
        + mcfg.reg_scalar_weight * reg_scalar
    )


def window_chunk_budget(bins_counts: torch.Tensor, chunk: int) -> int:
    """The System's chunk budget for a window (``slam/system.py:509-522`` of
    the JAX package): the most live chunks of any frame plus 64, rounded up
    to a multiple of 1024, at least 1024 and at most 2^15."""
    K = chunk
    nch = int(torch.div(bins_counts.long() + K - 1, K, rounding_mode="floor").sum(-1).max())
    b = max(-(-(nch + 64) // 1024) * 1024, 1024)
    return min(b, 1 << 15)


def window_layouts(
    frames: WindowFrames, capacity: int, cam: Camera, rcfg: RasterConfig, chunk_budget: int
) -> list[FrameLayout]:
    """Each live window frame's chunk layout and pack residuals (raises if
    a frame has more live chunks than ``chunk_budget``)."""
    ty, tx = tile_grid_shape(cam, rcfg)
    layouts = []
    for f in range(max(frames.n_frames, 1)):
        bins = TileBins(indices=frames.bins_indices[f], counts=frames.bins_counts[f],
                        n_dropped=frames.bins_counts.new_zeros(()))
        cbins = chunk_layout(bins, ty * tx, rcfg.chunk, chunk_budget)
        layouts.append(FrameLayout(cbins, flat_pack_grad_aux(cbins.indices, capacity)))
    return layouts


def map_loss_and_grads(
    gm: GaussianMap,
    frames: WindowFrames,
    k: int,
    layout: FrameLayout,
    cam: Camera,
    mcfg: MappingConfig,
    rcfg: RasterConfig,
    init_mode: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The mapping loss on window frame ``k`` and its gradient w.r.t. the
    five splat parameter groups."""
    params = {n: getattr(gm, n).detach().requires_grad_(True) for n in PARAM_NAMES}
    with torch.enable_grad():
        g2 = dataclasses.replace(gm, **params)
        prep = preprocess(
            g2.means, g2.rgb, g2.quats, g2.logit_opacities, g2.log_scales, g2.active,
            frames.poses[k], cam, mcfg.scale_modifier,
        )
        out = render_flat(prep, layout.cbins, cam, rcfg, bg=mcfg.background_color,
                          pack_aux=layout.pack_aux)
        loss = mapping_loss(g2, out, frames.colors[k], frames.depths[k], mcfg, init_mode)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)
    }


def map_step(
    gm: GaussianMap,
    frames: WindowFrames,
    k: int,
    layouts: list[FrameLayout],
    cam: Camera,
    mcfg: MappingConfig,
    rcfg: RasterConfig,
    init_mode: bool = False,
) -> tuple[GaussianMap, torch.Tensor]:
    """One mapping iteration on window frame ``k``: loss, gradients and one
    masked Adam step. Returns (new map, loss)."""
    loss, grads = map_loss_and_grads(gm, frames, k, layouts[k], cam, mcfg, rcfg, init_mode)
    return adam_step(gm, grads, map_learning_rates(mcfg)), loss


def map_window(
    gm: GaussianMap,
    frames: WindowFrames,
    frame_ids: list[int],
    cam: Camera,
    mcfg: MappingConfig,
    rcfg: RasterConfig,
    init_mode: bool = False,
    chunk_budget: int | None = None,
) -> tuple[GaussianMap, torch.Tensor]:
    """One Adam step on each window frame of ``frame_ids`` (the caller draws
    them, one per iteration); returns (map, per-iteration losses).
    ``chunk_budget`` (default ``rcfg.chunk_budget``; callers pass
    :func:`window_chunk_budget`) must hold every frame's live chunks."""
    layouts = window_layouts(frames, gm.capacity, cam, rcfg,
                             int(chunk_budget or rcfg.chunk_budget))
    losses = []
    for k in frame_ids:
        gm, loss = map_step(gm, frames, k, layouts, cam, mcfg, rcfg, init_mode)
        losses.append(loss)
    return gm, torch.stack(losses)


def build_window_frames(
    colors, depths, poses, bins_list, n_frames: int, window_size: int,
    device: torch.device | str = "cuda",
) -> WindowFrames:
    """Stack host-side frame data (numpy arrays or tensors; ``bins_list``
    of :class:`TileBins`) into padded tensors on ``device``."""
    W = window_size
    H, Wd = colors[0].shape[:2]
    T, cap = bins_list[0].indices.shape
    n = min(n_frames, W)
    c = np.zeros((W, H, Wd, 3), np.float32)
    d = np.zeros((W, H, Wd), np.float32)
    p = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    bi = np.full((W, T, cap), -1, np.int32)
    bc = np.zeros((W, T), np.int32)
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    for i in range(n):
        c[i] = host(colors[i])
        d[i] = host(depths[i])
        p[i] = host(poses[i])
        bi[i] = host(bins_list[i].indices)
        bc[i] = host(bins_list[i].counts)
    t = lambda x: torch.as_tensor(x, device=device)
    return WindowFrames(colors=t(c), depths=t(d), poses=t(p), bins_indices=t(bi),
                        bins_counts=t(bc), n_frames=n)


def prune_map(gm: GaussianMap, mcfg: MappingConfig) -> GaussianMap:
    """Periodic low-opacity prune and scene-radius refresh
    (``Render::RemoveGaussian`` + ``UpdataMaxZ``,
    ``src/Render.cc:211-217,657-663``); ``max_z`` only ratchets upward, as
    in the reference."""
    gm = prune_low_opacity(gm, mcfg.prune_opacities)
    return dataclasses.replace(gm, scene_radius=gm.max_z / mcfg.radius_depth_ratio)
