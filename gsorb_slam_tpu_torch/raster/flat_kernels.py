"""The flat-chunk blend of the mapping path, its kernels and their plain
PyTorch versions (counterpart of the flat-chunk section of
``gsorb_slam_tpu/raster/pallas_raster.py``).

The mapping render gathers only the live chunks of each tile
(:class:`~gsorb_slam_tpu_torch.raster.binning.ChunkBins`, built once per
binning episode) into a flat ``[MC, 16, K]`` pack and blends it tile by
tile. Two kernels live here, each beside its plain version:

- **K4** :func:`blend_flat_forward` (``csrc/blend_flat.cu``), replacing the
  TPU kernel ``_flat_fwd_kernel``. Plain version:
  :func:`blend_flat_forward_plain`, which lays the flat chunks back out per
  tile and runs :func:`~gsorb_slam_tpu_torch.raster.blend_kernels.blend_tiles`,
  so it is K3's plain version by construction. The kernel's warps walk only
  the slots whose footprint box meets their pixels; that cull's plain
  version is :func:`footprint_keep_plain`.
- **K5** :func:`blend_flat_backward` (``csrc/blend_flat.cu``), replacing
  ``_flat_bwd_kernel`` + ``_flat_chunk_grad``. Plain version:
  :func:`blend_flat_backward_plain`, ``torch.autograd`` through the plain
  forward.

:func:`blend_flat` joins the two in a ``torch.autograd.Function`` for CUDA
tensors and differentiates the plain forward for CPU tensors. A CUDA tensor
reaches the kernels or raises; there is no fallback.

The pack gather's backward (``blend_kernels.PackAux``, built once per
binning episode by ``blend_kernels.flat_pack_grad_aux``) sums each Gaussian's slots in
a fixed order from a slot table, not with a float-atomic scatter
(``index_add_`` adds with atomics on CUDA), so the mapped map is bitwise
reproducible.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import ChunkBins, tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    N_ATTR,
    PackAux,
    _check_tile_shape,
    _RowsGatherSorted,
    _words,
    attr_cols,
    blend_backward_plain,
    blend_tiles,
    footprint_keep,
    gate_edges,
    render_output_from_tiles,
    tile_pixels,
)
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput


# ---------------------------------------------------------------------------
# The pack gather (its sorted backward is blend_kernels.PackAux's)
# ---------------------------------------------------------------------------


def pack_instances_flat(
    prep: Preprocessed | torch.Tensor, cbins: ChunkBins, pack_aux: PackAux | None = None
) -> torch.Tensor:
    """Gather instance attributes into the flat ``[MC, 16, K]`` layout, from
    ``prep`` or from its attribute table ``[C + 1, 16]`` (``attr_cols``, or
    ``map_attr.map_attr_table``'s).

    ``pack_aux`` switches the gather's backward to the fixed-order sorted
    segment sum; without it autograd's scatter-add is used (the plain
    version; on CUDA its order varies from run to run)."""
    MC, K = cbins.indices.shape
    cols = attr_cols(prep) if isinstance(prep, Preprocessed) else prep
    C = cols.shape[0] - 1
    if pack_aux is not None:
        rows = _RowsGatherSorted.apply(cols, pack_aux)
    else:
        idx = torch.where(cbins.indices < 0, torch.full_like(cbins.indices, C), cbins.indices)
        rows = cols[idx.reshape(-1).long()]
    return rows.reshape(MC, K, N_ATTR).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# The plain versions: the flat chunks laid back out per tile
# ---------------------------------------------------------------------------


def _tile_layout(cbins: ChunkBins, n_tiles: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(dense [T, n] flat chunk id per (tile, position), MC where the tile
    has fewer chunks; live instances per tile [T]; n)``, n the most chunks
    of any tile (at least 1). A tile's live instances are a prefix of its
    slots, as in its bins."""
    MC = cbins.chunk_tile.shape[0]
    dev = cbins.chunk_tile.device
    n_ch = cbins.tile_start[1:] - cbins.tile_start[:-1]
    n = max(int(n_ch.max()) if n_tiles else 0, 1)
    dense = torch.full((n_tiles + 1, n), MC, dtype=torch.long, device=dev)
    live = cbins.chunk_tile < n_tiles
    cid = torch.arange(MC, device=dev)
    dense[cbins.chunk_tile[live].long(), cbins.chunk_pos[live].long()] = cid[live]
    per_chunk = (cbins.indices >= 0).sum(1)
    counts = torch.cat([per_chunk, per_chunk.new_zeros(1)])[dense[:n_tiles]].sum(1)
    return dense[:n_tiles], counts, n


def _per_tile(packed: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """The flat pack ``[MC, 16, K]`` laid out per tile ``[T, 16, n K]``
    (zero attributes past a tile's chunks); differentiable."""
    K = packed.shape[2]
    T, n = dense.shape
    pz = torch.cat([packed, packed.new_zeros((1, N_ATTR, K))], dim=0)
    return pz[dense].permute(0, 2, 1, 3).reshape(T, N_ATTR, n * K)


def _to_flat(per_tile: torch.Tensor, cbins: ChunkBins, n_tiles: int, K: int) -> torch.Tensor:
    """Per-chunk slices ``[MC, ...]`` of a per-tile tensor whose second axis
    is the chunk position (zeros for dead chunks)."""
    live = cbins.chunk_tile < n_tiles
    t = torch.clamp(cbins.chunk_tile, max=n_tiles - 1).long()
    x = per_tile[t, cbins.chunk_pos.long()]
    return torch.where(live.reshape((-1,) + (1,) * (x.ndim - 1)), x, torch.zeros_like(x))


def blend_flat_forward_plain(
    packed: torch.Tensor,  # [MC, 16, K]
    cbins: ChunkBins,
    cam: Camera,
    cfg: RasterConfig,
    pairs: dict[str, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's plain version: ``(out [T, 8, px], chunk_t [MC, px], last
    [T, px], visit [MC, px / 32, ceil(K / 32)])`` as the kernel writes them;
    differentiable w.r.t. ``packed`` through ``out`` (not the median row).
    ``visit`` holds K5's visit words (int32; bit b of word j of warp w is
    set iff one of the warp's 32 pixels applied slot 32 j + b of the
    chunk; zero for dead chunks). ``pairs`` as in ``blend_tiles``, over
    each tile's live instances (the padding slots of a tile's last chunk
    carry opacity 0: the kernel's cull skips them)."""
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    K = packed.shape[2]
    out, chunk_t, last, visit = _blend_per_tile(packed, cbins, cam, cfg, pairs=pairs,
                                                with_last=True, with_visit=True)
    return (out, _to_flat(chunk_t.detach(), cbins, n_tiles, K), last,
            _to_flat(visit, cbins, n_tiles, K))


def _blend_per_tile(packed: torch.Tensor, cbins: ChunkBins, cam: Camera, cfg: RasterConfig,
                    **kw) -> tuple[torch.Tensor, ...]:
    """``blend_tiles`` over the flat chunks laid back out per tile."""
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    dense, counts, _ = _tile_layout(cbins, n_tiles)
    pu, pv = tile_pixels(torch.arange(n_tiles, device=packed.device), tx,
                         cfg.tile_w_px, cfg.tile_h_px)
    return blend_tiles(_per_tile(packed, dense), counts, pu, pv, packed.shape[2],
                       cfg.exact_stop, False, **kw)


def blend_flat_backward_plain(
    packed: torch.Tensor,
    cbins: ChunkBins,
    g_out: torch.Tensor,  # [T, 8, px]
    cam: Camera,
    cfg: RasterConfig,
    tile_batch: int | None = None,
) -> torch.Tensor:
    """K5's plain version: ``torch.autograd`` through the plain forward ->
    ``grads [MC, 16, K]``. ``tile_batch`` differentiates that many tiles at
    a time (the tiles blend independently), which bounds the memory the
    autograd graph holds at full width."""
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    K = packed.shape[2]
    dense, counts, _ = _tile_layout(cbins, n_tiles)
    d_tiles = blend_backward_plain(_per_tile(packed.detach(), dense), counts, g_out, cam,
                                   cfg, tile_batch)
    T, _, cap = d_tiles.shape
    per_chunk = d_tiles.reshape(T, N_ATTR, cap // K, K).transpose(1, 2)  # [T, n, 16, K]
    return _to_flat(per_chunk, cbins, n_tiles, K)


def cotangent_without_gate_edges(
    packed: torch.Tensor,
    cbins: ChunkBins,
    g_out: torch.Tensor,  # [T, 8, px]
    cam: Camera,
    cfg: RasterConfig,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, int]:
    """``g_out`` with zeros at the pixels where the blend is discontinuous
    within rounding, and their number.

    Those are the pixels where some instance of the tile has an alpha
    within ``eps`` (relative) of the 1/255 gate or of the 0.99 clamp: a
    kernel and its plain version may round to opposite sides there, which
    switches that instance's contribution on or off and moves the pixel's
    gradients by more than rounding. With a zero cotangent the pixel sends
    no gradient in either version."""
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    K = packed.shape[2]
    dense, _, _ = _tile_layout(cbins, n_tiles)
    pu, pv = tile_pixels(torch.arange(n_tiles, device=packed.device), tx,
                         cfg.tile_w_px, cfg.tile_h_px)
    edge = gate_edges(_per_tile(packed.detach(), dense), pu, pv, K, eps)
    g = g_out.clone()
    g.masked_fill_(edge[:, None, :], 0.0)
    return g, int(edge.sum())


def footprint_keep_plain(
    packed: torch.Tensor, cbins: ChunkBins, cam: Camera, cfg: RasterConfig
) -> torch.Tensor:
    """``[MC, px / 32, K]`` bool: the slots of each flat chunk that K4's
    warps evaluate, the plain version of its footprint cull
    (``blend_kernels.footprint_keep`` against the pixel rectangle of each
    warp of the chunk's tile; dead chunks keep nothing). A culled pair
    cannot pass the blend's gate, so every slot a warp applies (the visit
    words) is kept."""
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    tile = torch.clamp(cbins.chunk_tile, max=n_tiles - 1)
    pu, pv = tile_pixels(tile, tx, cfg.tile_w_px, cfg.tile_h_px)
    keep = footprint_keep(packed, pu, pv)
    return keep & (cbins.chunk_tile < n_tiles)[:, None, None]


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _flat_args(packed: torch.Tensor, cbins: ChunkBins, cam: Camera, cfg: RasterConfig):
    _check_tile_shape(cfg)
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles = ty * tx
    MC, _, K = packed.shape
    dev = packed.device
    _build.check_tensor(packed, "packed", torch.float32, (MC, N_ATTR, K), dev)
    _build.check_tensor(cbins.tile_start, "tile_start", torch.int32, (n_tiles + 1,), dev)
    return n_tiles, tx, MC, K, cfg.tile_w_px * cfg.tile_h_px, dev


def blend_flat_forward(
    packed: torch.Tensor, cbins: ChunkBins, cam: Camera, cfg: RasterConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: the flat-chunk forward blend -> ``(out [T, 8, px], chunk_t
    [MC, px], last [T, px], visit [MC, px / 32, ceil(K / 32)])``, the last
    three K5's residuals. CUDA tensors launch the kernel, CPU tensors take
    :func:`blend_flat_forward_plain`. Forward only: differentiate through
    :func:`blend_flat`."""
    if not packed.is_cuda:
        return blend_flat_forward_plain(packed, cbins, cam, cfg)
    if torch.is_grad_enabled() and packed.requires_grad:
        raise ValueError("blend_flat_forward is forward only: differentiate through blend_flat")
    n_tiles, tx, MC, K, px, dev = _flat_args(packed, cbins, cam, cfg)
    out = torch.empty((n_tiles, 8, px), dtype=torch.float32, device=dev)
    chunk_t = torch.zeros((MC, px), dtype=torch.float32, device=dev)
    last = torch.empty((n_tiles, px), dtype=torch.int32, device=dev)
    visit = torch.zeros((MC, px // 32, _words(K)), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.count_launch("blend_flat_fwd")
    err = lib.gsorb_blend_flat_fwd(
        packed.data_ptr(), cbins.tile_start.data_ptr(), out.data_ptr(), chunk_t.data_ptr(),
        last.data_ptr(), visit.data_ptr(), n_tiles, K, tx, cfg.tile_w_px, cfg.tile_h_px,
        int(cfg.exact_stop), _build.stream_handle(dev),
    )
    _build.check(err, "blend_flat_fwd")
    return out, chunk_t, last, visit


def blend_flat_backward(
    packed: torch.Tensor,  # [MC, 16, K]
    cbins: ChunkBins,
    out: torch.Tensor,  # [T, 8, px] from K4
    chunk_t: torch.Tensor,  # [MC, px] from K4
    last: torch.Tensor,  # [T, px] from K4
    visit: torch.Tensor,  # [MC, px / 32, ceil(K / 32)] from K4
    g_out: torch.Tensor,  # [T, 8, px] cotangent of out
    cam: Camera,
    cfg: RasterConfig,
) -> torch.Tensor:
    """K5: the flat-chunk backward -> ``grads [MC, 16, K]`` (rows d_mu,
    d_mv, d_ca, d_cb, d_cc, d_op, d_r, d_g, d_b, d_z; rows 10-15 zero).
    ``out, chunk_t, last, visit`` are K4's results, in the order
    :func:`blend_flat_forward` returns them. The kernel writes every
    element, dead chunks included.
    CUDA tensors launch the kernel, CPU tensors take
    :func:`blend_flat_backward_plain` (which needs none of K4's
    residuals)."""
    if not packed.is_cuda:
        return blend_flat_backward_plain(packed, cbins, g_out, cam, cfg)
    n_tiles, tx, MC, K, px, dev = _flat_args(packed, cbins, cam, cfg)
    _build.check_tensor(chunk_t, "chunk_t", torch.float32, (MC, px), dev)
    _build.check_tensor(last, "last", torch.int32, (n_tiles, px), dev)
    _build.check_tensor(out, "out", torch.float32, (n_tiles, 8, px), dev)
    _build.check_tensor(g_out, "g_out", torch.float32, (n_tiles, 8, px), dev)
    _build.check_tensor(visit, "visit", torch.int32, (MC, px // 32, _words(K)), dev)
    grads = torch.empty((MC, N_ATTR, K), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch("blend_flat_bwd")
    err = lib.gsorb_blend_flat_bwd(
        packed.data_ptr(), cbins.tile_start.data_ptr(), chunk_t.data_ptr(), last.data_ptr(),
        visit.data_ptr(), out.data_ptr(), g_out.data_ptr(), grads.data_ptr(), n_tiles, MC, K,
        tx, cfg.tile_w_px, cfg.tile_h_px, _build.stream_handle(dev),
    )
    _build.check(err, "blend_flat_bwd")
    return grads


class _BlendFlat(torch.autograd.Function):
    """K4 forward, K5 backward."""

    @staticmethod
    def forward(ctx, packed, cbins, cam, cfg):
        out, chunk_t, last, visit = blend_flat_forward(packed, cbins, cam, cfg)
        ctx.save_for_backward(packed, out, chunk_t, last, visit)
        ctx.cbins, ctx.cam, ctx.cfg = cbins, cam, cfg
        return out

    @staticmethod
    def backward(ctx, g_out):
        packed, out, chunk_t, last, visit = ctx.saved_tensors
        grads = blend_flat_backward(packed, ctx.cbins, out, chunk_t, last, visit,
                                    g_out.contiguous(), ctx.cam, ctx.cfg)
        return grads, None, None, None


def blend_flat(
    packed: torch.Tensor, cbins: ChunkBins, cam: Camera, cfg: RasterConfig
) -> torch.Tensor:
    """The differentiable flat-chunk blend -> ``out [T, 8, px]``: K4 / K5 for
    CUDA tensors, autograd through the plain forward for CPU tensors."""
    if packed.is_cuda:
        return _BlendFlat.apply(packed, cbins, cam, cfg)
    return _blend_per_tile(packed, cbins, cam, cfg)[0]


def render_flat(
    prep: Preprocessed | tuple[torch.Tensor, torch.Tensor],
    cbins: ChunkBins,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
    pack_aux: PackAux | None = None,
) -> RenderOutput:
    """The flat-chunk mapping render (counterpart of ``render_pallas_flat``)
    of ``prep`` or of its ``(attribute table, radius)``
    (``map_attr.map_attr_table``): one gather bounded by the live instance
    count, then the flat blend. The median depth carries no gradient; the
    background adds ``final_t * bg``."""
    cols, radius = (attr_cols(prep), prep.radius) if isinstance(prep, Preprocessed) else prep
    packed = pack_instances_flat(cols, cbins, pack_aux)
    out = blend_flat(packed, cbins, cam, cfg)
    return render_output_from_tiles(out, cam, cfg, bg, radius)
