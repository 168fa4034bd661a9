"""Paired-rect fused tracking (counterpart of ``gsorb_slam_tpu/raster/paired.py``).

The tracking view bins 16x8 rect tiles, half a square tile each, and the
tiles are tracked two at a time in pair-major order: rows ``2p`` and
``2p + 1`` of the packed instances, counts, tile ids and gradients are the
two halves of pair ``p``. By default the pairing is count-sorted (the tiles
in descending instance count, rank ``2i`` with ``2i + 1``), so the chunks a
pair walks, max(c_A, c_B), are few and empty tiles pair with empty tiles;
``paired_sort=False`` pairs the static vertical neighbours of
:func:`pair_permutation`.

**K8** :func:`tracking_loss_grad_paired` (``csrc/fused_track.cu``) replaces
the TPU kernel ``_paired_track_kernel``: one block of 256 threads per pair,
each half blending its own instance list with the fast stop rule. The TPU
kernel's two-tiles-per-256-lane slab and block-diagonal pixel basis exist
for Mosaic's layouts and are not carried over. Its plain version,
:func:`tracking_loss_grad_paired_plain`, is K1's plain version over the rect
tiles with ``tile_ids`` = the pairing and the gt un-paired, so K8 is by
construction K1 over a 16x8 tiling. A CUDA tensor launches K8 (or raises),
a CPU tensor takes the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins, tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    MAX_TILE_PX,
    N_ATTR,
    tile_gt_images,
    tracking_loss_grad_plain,
)
from gsorb_slam_tpu_torch.raster.types import RasterConfig


def pair_permutation(ty: int, tx: int) -> np.ndarray:
    """``[ty * tx]`` row-major rect-tile ids in pair-major order: slot ``2p``
    is the upper half of pair ``p``, slot ``2p + 1`` the lower half; pair
    ``p`` covers the square tile at rect row ``2 (p // tx)``, column
    ``p % tx``."""
    if ty % 2:
        raise ValueError(f"paired tiling needs an even rect-tile row count (got {ty})")
    p = np.arange(ty // 2 * tx)
    py, pxc = p // tx, p % tx
    a = (2 * py) * tx + pxc
    b = (2 * py + 1) * tx + pxc
    return np.stack([a, b], 1).reshape(-1).astype(np.int32)


def count_sorted_pair_permutation(counts: torch.Tensor) -> torch.Tensor:
    """``[Tr]`` rect-tile ids in descending-count order (int32). Ties keep
    the lower tile id first, as the JAX package's stable argsort does."""
    return torch.argsort(-counts.to(torch.int32), stable=True).to(torch.int32)


def tracking_pair_order(bins: TileBins, cam: Camera, cfg: RasterConfig) -> torch.Tensor:
    """The pairing of one binning episode: :func:`count_sorted_pair_permutation`
    of its counts, or with ``paired_sort=False`` :func:`pair_permutation`."""
    if cfg.paired_sort:
        return count_sorted_pair_permutation(bins.counts)
    ty, tx = tile_grid_shape(cam, cfg)
    return torch.as_tensor(pair_permutation(ty, tx), device=bins.counts.device)


def pair_bins(bins: TileBins, perm: torch.Tensor) -> TileBins:
    """The bins' rows in the pair-major order ``perm``."""
    p = perm.long()
    return TileBins(indices=bins.indices[p], counts=bins.counts[p], n_dropped=bins.n_dropped)


def pack_gt_pairs(
    gt_color: torch.Tensor,
    gt_depth: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[Tr / 2, 4, 2 * rect_px]`` gt tiles in the paired layout: row ``r`` of
    pair ``p`` holds the first rect tile ``perm[2p]`` in lanes
    ``[0, rect_px)`` and the second ``perm[2p + 1]`` in ``[rect_px,
    2 rect_px)``. ``perm`` defaults to :func:`pair_permutation`."""
    gt4 = tile_gt_images(gt_color, gt_depth, cam, cfg)  # [Tr, 4, rect_px]
    ty, tx = tile_grid_shape(cam, cfg)
    if perm is None:
        perm = torch.as_tensor(pair_permutation(ty, tx), device=gt4.device)
    return pair_gt_rows(gt4[perm.long()])


def pair_gt_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rect-tile gt rows ``[Tr, 4, rect_px]`` in pair-major order -> the paired
    layout ``[Tr / 2, 4, 2 * rect_px]``."""
    tr, _, rp = rows.shape
    return rows.reshape(tr // 2, 2, 4, rp).transpose(1, 2).reshape(tr // 2, 4, 2 * rp).contiguous()


def unpack_gt_pairs(gt_pairs: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pair_gt_rows`: ``[Tr, 4, rect_px]`` rows in
    pair-major order."""
    tp, _, px2 = gt_pairs.shape
    rp = px2 // 2
    return gt_pairs.reshape(tp, 4, 2, rp).transpose(1, 2).reshape(2 * tp, 4, rp)


def _check_paired(cfg: RasterConfig) -> None:
    if cfg.exact_stop:
        raise ValueError("paired tracking implements the fast stop rule only (exact_stop=False)")


def tracking_loss_grad_paired_plain(
    packed: torch.Tensor,
    counts: torch.Tensor,
    gt_pairs: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    tile_ids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's plain version: K1's plain version over the rect tiles, rows in
    pair-major order with their global ids ``tile_ids`` and the gt
    un-paired."""
    _check_paired(cfg)
    return tracking_loss_grad_plain(
        packed, counts, unpack_gt_pairs(gt_pairs), cam, cfg, im_weight, depth_weight,
        use_sur_depth, tile_ids,
    )


def tracking_loss_grad_paired(
    packed: torch.Tensor,  # [Tr, 16, cap] screen instances, pair-major
    counts: torch.Tensor,  # [Tr] int32, pair-major
    gt_pairs: torch.Tensor,  # [Tr / 2, 4, 2 * rect_px] (pack_gt_pairs)
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    tile_ids: torch.Tensor,  # [Tr] int32 rect tile id of each row
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: one fused paired-rect tracking iteration -> ``(im_w * image_l1,
    depth_w * depth_l1, d_packed [Tr, 16, cap])``, the gradients pair-major
    like ``packed``. CUDA tensors launch the kernel, CPU tensors take
    :func:`tracking_loss_grad_paired_plain`."""
    if not packed.is_cuda:
        return tracking_loss_grad_paired_plain(
            packed, counts, gt_pairs, cam, cfg, im_weight, depth_weight, use_sur_depth,
            tile_ids,
        )
    _check_paired(cfg)
    n_tiles, _, cap = packed.shape
    rect_px = cfg.tile_w_px * cfg.tile_h_px
    if n_tiles % 2 or rect_px % 32 or 2 * rect_px > MAX_TILE_PX:
        raise ValueError(
            f"K8 needs an even number of rect tiles of at most {MAX_TILE_PX // 2} pixels, "
            f"a multiple of 32; got {n_tiles} tiles of {rect_px}"
        )
    K = min(cfg.chunk, cap)
    if cap % K:
        raise ValueError(f"tile capacity {cap} is not a multiple of the chunk {K}")
    ty, tx = tile_grid_shape(cam, cfg)
    dev = packed.device
    packed = packed.detach()
    _build.check_tensor(packed, "packed", torch.float32, (n_tiles, N_ATTR, cap), dev)
    _build.check_tensor(counts, "counts", torch.int32, (n_tiles,), dev)
    _build.check_tensor(tile_ids, "tile_ids", torch.int32, (n_tiles,), dev)
    _build.check_tensor(gt_pairs, "gt_pairs", torch.float32, (n_tiles // 2, 4, 2 * rect_px), dev)
    grads = torch.empty((n_tiles, N_ATTR, cap), dtype=torch.float32, device=dev)
    loss = torch.empty((n_tiles, 2), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch("paired_track")
    err = lib.gsorb_paired_track(
        packed.data_ptr(), counts.data_ptr(), tile_ids.data_ptr(), gt_pairs.data_ptr(),
        grads.data_ptr(), loss.data_ptr(), n_tiles, cap, K, tx, cfg.tile_w_px,
        cfg.tile_h_px, float(im_weight), float(depth_weight), int(bool(use_sur_depth)),
        _build.stream_handle(dev),
    )
    _build.check(err, "paired_track")
    sums = loss.sum(0)
    return sums[0], sums[1], grads
