"""Shared rasterizer types (counterpart of ``gsorb_slam_tpu/raster/types.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer knobs.

    Keeps every field of the JAX package's ``RasterConfig`` so a
    configuration converts one to one (``interop.raster_config_from_dict``).
    The port computes in float32 throughout. These fields exist only for the
    TPU kernels' layout and are accepted with no effect here:
    ``blend_bf16``, ``elem_bf16``, ``chunk_unroll``, ``fused_tiles_per_step``,
    ``fused_chunk_batch``, ``flat_group``, ``preprocess_pallas`` and
    ``debug_loss``. ``backend`` is likewise ignored: the device of the input
    tensors selects the path (a CUDA tensor runs the CUDA kernels, a CPU
    tensor their plain PyTorch versions). ``paired`` and ``paired_sort``
    take effect in tracking, as in the JAX package: the tracking view bins
    16x8 rect tiles in pair-major order (``slam.tracking``).
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
    backend: str = "auto"
    # Early-stop semantics. True = CUDA-exact (the instance whose blend
    # would cross T<1e-4 is NOT applied). False = fast mode: instances apply
    # while their incoming transmittance is >= 1e-4.
    exact_stop: bool = True
    chunk_unroll: int = 4
    blend_bf16: bool = False
    elem_bf16: bool = False
    # Static chunk budget for the flat-chunk mapping path.
    chunk_budget: int = 8192
    flat_group: int = 4
    fused_tiles_per_step: int = 4
    # Paired-rect tracking: the tracking view bins 16x8 rect tiles, two per
    # square tile, and tracks them in pair-major order (fast stop only).
    paired: bool = False
    # Chunk K for the tracking view only (0 = chunk).
    track_chunk: int = 0
    fused_chunk_batch: int = 1
    sorted_pack_grad: bool = True
    # Paired tracking pairs tiles by descending instance count (True) or as
    # static vertical neighbours (False).
    paired_sort: bool = True
    preprocess_pallas: bool = True
    debug_loss: bool = False

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
