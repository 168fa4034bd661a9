"""Tile binning: which Gaussians touch which image tile, depth-ordered
(counterpart of ``gsorb_slam_tpu/raster/binning.py``).

Same algorithm as the CUDA pipeline's ``InclusiveSum -> duplicateWithKeys
-> RadixSort -> identifyTileRanges`` (``rasterizer_impl.cu:280-342``):

1. per-Gaussian tile rect (clamped to ``max_dup`` tiles) -> up to
   ``max_dup`` (tile, depth, gaussian) instances each, with the conic-rect
   cull;
2. one lexicographic (tile, depth) sort over all C*D candidates, ties in
   gaussian-id order (invalid slots carry the sentinel tile ``n_tiles`` and
   depth ``inf`` and sort to the tail);
3. per-tile ranges via ``searchsorted``, then a gather into
   fixed-capacity per-tile index lists.

The order equals the JAX package's stable ``lax.sort`` index for index:
two stable passes, depth first, then tile. :func:`chunk_layout` enumerates
the live chunks of the bins for the mapping path's flat-chunk blend.
"""

from __future__ import annotations

import dataclasses

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig


@dataclasses.dataclass
class TileBins:
    indices: torch.Tensor  # [T, cap] int32 gaussian ids, -1 padded
    counts: torch.Tensor  # [T] int32 live entries per tile
    n_dropped: torch.Tensor  # [] int32 instances lost to capacity overflow


@dataclasses.dataclass
class ChunkBins:
    """Flat-chunk view of :class:`TileBins` for the mapping path: only the
    ceil(count/K) live chunks of each tile, concatenated across tiles in
    tile order. Dead tail chunks carry tile id ``n_tiles`` and index -1.

    The first four fields equal the JAX package's ``ChunkBins`` index for
    index; ``tile_start`` (the first flat chunk of each tile, ``[T + 1]``)
    is the port's own: the flat blend kernels run one block per tile over
    the chunk range ``[tile_start[t], tile_start[t + 1])``."""

    indices: torch.Tensor  # [MC, K] int32 gaussian ids (-1 dead)
    chunk_tile: torch.Tensor  # [MC] int32 owning tile (n_tiles = dead)
    chunk_pos: torch.Tensor  # [MC] int32 chunk position within its tile
    n_chunks: torch.Tensor  # [] int32 live chunk count
    tile_start: torch.Tensor  # [T + 1] int32 first flat chunk of each tile


def chunk_layout(bins: TileBins, n_tiles: int, chunk: int, chunk_budget: int) -> ChunkBins:
    """The flat-chunk enumeration of per-tile bins (counterpart of the JAX
    ``chunk_layout``), built once per binning episode.

    The JAX version silently drops the tail tiles when ``chunk_budget`` is
    below the live chunk count; this one raises instead."""
    K = chunk
    dev = bins.indices.device
    cap = bins.indices.shape[1]
    nchunks = torch.div(bins.counts.long() + K - 1, K, rounding_mode="floor")  # [T]
    cstart = torch.cat([nchunks.new_zeros(1), torch.cumsum(nchunks, 0)])  # [T + 1]
    total = int(cstart[-1])
    if total > chunk_budget:
        raise ValueError(f"{total} live chunks exceed the chunk budget {chunk_budget}")
    cid = torch.arange(chunk_budget, device=dev)
    tile_of = torch.searchsorted(cstart, cid, right=True) - 1
    live = cid < total
    tile_of = torch.where(live, tile_of, torch.full_like(tile_of, n_tiles))
    t_clip = torch.clamp(tile_of, max=n_tiles - 1)
    pos = torch.where(live, cid - cstart[t_clip], torch.zeros_like(cid))
    flat = bins.indices.reshape(-1)
    src = (t_clip * cap + pos * K)[:, None] + torch.arange(K, device=dev)[None, :]
    idx = torch.where(
        live[:, None], flat[torch.clamp(src, max=n_tiles * cap - 1)], torch.full_like(src, -1)
    )
    i32 = torch.int32
    return ChunkBins(
        indices=idx.to(i32),
        chunk_tile=tile_of.to(i32),
        chunk_pos=pos.to(i32),
        n_chunks=cstart[-1].to(i32),
        tile_start=cstart.to(i32),
    )


def tile_grid_shape(cam: Camera, cfg: RasterConfig) -> tuple[int, int]:
    return (-(-cam.height // cfg.tile_h_px), -(-cam.width // cfg.tile_w_px))


def gaussian_tile_rect(
    prep: Preprocessed, cam: Camera, cfg: RasterConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamped tile rect per Gaussian: (start_x, start_y, w, h) in tiles.

    CUDA ``getRect`` semantics (``auxiliary.h``), additionally clamped to at
    most ``max_dup`` tiles centered on the mean's own tile. A Gaussian
    contributes only within this rect."""
    ty, tx = tile_grid_shape(cam, cfg)
    u = prep.mean2d[:, 0]
    v = prep.mean2d[:, 1]
    r = prep.radius + cfg.dilate_px
    D = cfg.max_dup

    tw, th = cfg.tile_w_px, cfg.tile_h_px
    i32 = torch.int32
    x0 = torch.clamp(torch.floor((u - r) / tw), 0, tx).to(i32)
    x1 = torch.clamp(torch.floor((u + r) / tw) + 1, 0, tx).to(i32)
    y0 = torch.clamp(torch.floor((v - r) / th), 0, ty).to(i32)
    y1 = torch.clamp(torch.floor((v + r) / th) + 1, 0, ty).to(i32)
    w = x1 - x0
    h = y1 - y0

    cw = torch.clamp(w, max=D)
    ch = torch.minimum(h, torch.clamp(D // torch.clamp(cw, min=1), min=1))
    cx_t = torch.clamp((u / tw).to(i32), 0, tx - 1)
    cy_t = torch.clamp((v / th).to(i32), 0, ty - 1)
    sx = torch.minimum(torch.maximum(cx_t - cw // 2, x0), torch.maximum(x1 - cw, x0))
    sy = torch.minimum(torch.maximum(cy_t - ch // 2, y0), torch.maximum(y1 - ch, y0))
    return sx, sy, cw, ch


def bin_gaussians(prep: Preprocessed, cam: Camera, cfg: RasterConfig) -> TileBins:
    C = prep.depth.shape[0]
    dev = prep.depth.device
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    D = cfg.max_dup

    sx, sy, cw, ch = gaussian_tile_rect(prep, cam, cfg)

    d = torch.arange(D, dtype=torch.int32, device=dev)
    cw1 = torch.clamp(cw, min=1)[:, None]
    dx = d[None, :] % cw1
    dy = torch.div(d[None, :], cw1, rounding_mode="floor")
    dup_ok = (d[None, :] < (cw * ch)[:, None]) & prep.valid[:, None]
    tile_x = sx[:, None] + dx
    tile_y = sy[:, None] + dy
    # Conic-rect cull: a tile where even the minimum of the conic quadratic
    # over the (dilate-expanded) tile rect gives op*exp(-q/2) < 1/255
    # contributes nothing anywhere (forward.cu:316-321). The 1.44x q margin
    # and the dilate expansion cover pose drift between binning episodes.
    u = prep.mean2d[:, 0][:, None]
    v = prep.mean2d[:, 1][:, None]
    dil = float(cfg.dilate_px)
    cx0 = tile_x.to(torch.float32) * cfg.tile_w_px
    cy0 = tile_y.to(torch.float32) * cfg.tile_h_px
    ulo, uhi = cx0 - dil - u, cx0 + cfg.tile_w_px + dil - u
    vlo, vhi = cy0 - dil - v, cy0 + cfg.tile_h_px + dil - v
    A = torch.clamp(prep.conic[:, 0], min=1e-12)[:, None]
    Bc = prep.conic[:, 1][:, None]
    Cc = torch.clamp(prep.conic[:, 2], min=1e-12)[:, None]

    def _q(du, dv):
        return A * du * du + 2.0 * Bc * du * dv + Cc * dv * dv

    def _clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def _edge_u(ufix):  # min over dv in [vlo, vhi] at du = ufix
        return _q(ufix, _clip(-Bc * ufix / Cc, vlo, vhi))

    def _edge_v(vfix):  # min over du in [ulo, uhi] at dv = vfix
        return _q(_clip(-Bc * vfix / A, ulo, uhi), vfix)

    inside = (ulo <= 0.0) & (uhi >= 0.0) & (vlo <= 0.0) & (vhi >= 0.0)
    q_min = torch.minimum(
        torch.minimum(_edge_u(ulo), _edge_u(uhi)),
        torch.minimum(_edge_v(vlo), _edge_v(vhi)),
    )
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    q_max = 2.0 * torch.log(torch.clamp(255.0 * prep.opacity, min=1.0))[:, None]
    dup_ok = dup_ok & (q_min <= 1.44 * q_max)
    tile_id = torch.where(dup_ok, tile_y * tx + tile_x, torch.full_like(tile_x, n_tiles))

    # Lexicographic (tile, depth) sort, ties in gaussian-id order: two
    # stable passes, the minor key (depth) first.
    flat_tile = tile_id.reshape(-1)
    flat_depth = torch.where(
        dup_ok, prep.depth[:, None].expand(C, D), torch.full((C, D), float("inf"), device=dev)
    ).reshape(-1)
    order = torch.sort(flat_depth, stable=True).indices
    order = order[torch.sort(flat_tile[order], stable=True).indices]
    s_tile = flat_tile[order].contiguous()
    s_gid = torch.div(order, D, rounding_mode="floor").to(torch.int32)

    # Per-tile ranges (identifyTileRanges equivalent).
    tid = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(s_tile, tid, side="left").to(torch.int32)
    ends = torch.searchsorted(s_tile, tid + 1, side="left").to(torch.int32)
    counts = torch.clamp(ends - starts, max=cfg.tile_capacity)
    n_over_cap = (ends - starts - counts).sum(dtype=torch.int32)

    k = torch.arange(cfg.tile_capacity, dtype=torch.int32, device=dev)
    gather_pos = torch.clamp(starts[:, None] + k[None, :], max=C * D - 1)
    live = k[None, :] < counts[:, None]
    idx = torch.where(live, s_gid[gather_pos.long()], torch.full_like(gather_pos, -1))
    return TileBins(indices=idx, counts=counts, n_dropped=n_over_cap)
