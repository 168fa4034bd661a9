"""Shared rasterizer types (counterpart of ``gsorb_slam_tpu/raster/types.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer knobs: the tile grid and capacities, the chunk
    sizes, the bin dilation, the early-stop rule and paired tracking.

    The port computes in float32 throughout, and the device of the input
    tensors selects the path (a CUDA tensor runs the CUDA kernels, a CPU
    tensor their plain PyTorch versions). ``interop.raster_config_from_dict``
    converts the JAX package's ``RasterConfig``, dropping its fields that
    only lay out TPU kernels. ``paired`` and ``paired_sort`` take effect in
    tracking, as in the JAX package: the tracking view bins 16x8 rect tiles
    in pair-major order (``slam.tracking``).
    """

    tile: int = 16
    # Tile height in pixels (0 = square, i.e. `tile`).
    tile_h: int = 0
    # Max depth-sorted instances blended per tile; the farthest are dropped.
    tile_capacity: int = 1024
    # Tile capacity for the tracking path only (0 = tile_capacity).
    track_tile_capacity: int = 0
    # Max tiles a single Gaussian may be duplicated into.
    max_dup: int = 16
    # Instances staged per step inside a tile.
    chunk: int = 128
    # Extra pixels added to each Gaussian's tile rect so cached bins stay
    # valid while the pose drifts between binning episodes.
    dilate_px: float = 0.0
    # Early-stop semantics. True = CUDA-exact (the instance whose blend
    # would cross T<1e-4 is NOT applied). False = fast mode: instances apply
    # while their incoming transmittance is >= 1e-4.
    exact_stop: bool = True
    # Static chunk budget for the flat-chunk mapping path.
    chunk_budget: int = 8192
    # Paired-rect tracking: the tracking view bins 16x8 rect tiles, two per
    # square tile, and tracks them in pair-major order (fast stop only).
    paired: bool = False
    # Chunk K for the tracking view only (0 = chunk).
    track_chunk: int = 0
    # Paired tracking pairs tiles by descending instance count (True) or as
    # static vertical neighbours (False).
    paired_sort: bool = True

    @property
    def tile_w_px(self) -> int:
        return self.tile

    @property
    def tile_h_px(self) -> int:
        return self.tile_h or self.tile


@dataclasses.dataclass
class RenderOutput:
    """Every image the tracker and mapper read, from one blend pass."""

    color: torch.Tensor  # [H, W, 3] = sum c a T + T_final * bg
    depth: torch.Tensor  # [H, W] alpha-blended z (differentiable)
    alpha: torch.Tensor  # [H, W] accumulated opacity = sum a T
    median_depth: torch.Tensor  # [H, W] z at the T=0.5 crossing (no gradient)
    final_t: torch.Tensor  # [H, W] remaining transmittance
    radii: torch.Tensor  # [C] per-Gaussian pixel radius (0 = culled)
