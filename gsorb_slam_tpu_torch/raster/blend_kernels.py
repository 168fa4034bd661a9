"""The per-tile blend kernels and their plain PyTorch versions (counterpart
of ``gsorb_slam_tpu/raster/pallas_raster.py`` for the tracking and render
path).

Two kernels live here, each beside a plain version of the same function:

- **K3** :func:`blend_forward` (``csrc/blend_forward.cu``), replacing the
  TPU per-tile forward blend ``_fwd_kernel``. Plain version:
  :func:`blend_forward_plain`.
- **K1** :func:`tracking_loss_grad` (``csrc/fused_track_fast.cu``),
  replacing the TPU fused tracking kernel ``_fused_track_kernel_fast``:
  forward blend + masked L1 + cotangents + backward in one launch. Plain
  version: :func:`tracking_loss_grad_plain` (the same blend, the masked L1,
  and ``torch.autograd`` down to the packed instances).

A wrapper launches its kernel for a CUDA tensor (or raises: there is no
fallback) and takes the plain version only for a tensor on the CPU.

Both plain versions run the blend in :func:`blend_tiles`, which implements
the kernels' per-pixel stop rules exactly, so the on-card comparison is
tight: the fast rule applies an instance while the pixel's incoming
transmittance is >= 1e-4; the exact rule does not apply the instance whose
blend would take it below 1e-4.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins, tile_grid_shape
from gsorb_slam_tpu_torch.raster.naive import MIN_ALPHA, STOP_T
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput

# Packed attribute rows (the opacity row is pre-multiplied by validity, so
# dead instances blend with alpha exactly 0).
MU, MV, CA, CB, CC, OP, R, G, B, Z, LIVE = range(11)
N_ATTR = 16
N_GRAD = 10  # d_mu, d_mv, d_ca, d_cb, d_cc, d_op, d_r, d_g, d_b, d_z
MAX_TILE_PX = 256  # threads per block of the blend kernels: one per pixel


def attr_cols(prep: Preprocessed) -> torch.Tensor:
    """The packed attribute table ``[C + 1, 16]`` with a zero sentinel row
    (row C), which padding slots read. Conic rows are masked by validity:
    invalid conics can be garbage (det <= 0)."""
    vf = prep.valid.to(torch.float32)
    z = torch.zeros_like(prep.opacity)
    cols = torch.stack(
        [
            prep.mean2d[:, 0],
            prep.mean2d[:, 1],
            prep.conic[:, 0] * vf,
            prep.conic[:, 1] * vf,
            prep.conic[:, 2] * vf,
            prep.opacity * vf,
            prep.color[:, 0],
            prep.color[:, 1],
            prep.color[:, 2],
            torch.where(prep.valid, prep.depth, z),
            vf,
            z, z, z, z, z,
        ],
        dim=1,
    )  # [C, 16]
    return torch.cat([cols, cols.new_zeros((1, N_ATTR))], dim=0)


def pack_instances(prep: Preprocessed, bins: TileBins) -> torch.Tensor:
    """Gather per-tile instance attributes into ``[T, 16, cap]``.

    Padding entries (``bins.indices == -1`` or past the tile's count) read
    the zero sentinel row of :func:`attr_cols`, so dead slots blend with
    opacity 0."""
    T, cap = bins.indices.shape
    C = prep.depth.shape[0]
    cols = attr_cols(prep)
    k = torch.arange(cap, device=bins.indices.device)
    dead = (bins.indices < 0) | (k[None, :] >= bins.counts[:, None])
    idx = torch.where(dead, torch.full_like(bins.indices, C), bins.indices)
    rows = cols[idx.reshape(-1).long()].reshape(T, cap, N_ATTR)
    return rows.transpose(1, 2).contiguous()


def tile_pixels(
    tile_ids: torch.Tensor, tiles_x: int, ts_x: int, ts_y: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel coordinates ``(pu, pv)``, each ``[T, px]``, of the
    given global tiles (row-major pixels inside a tile, no +0.5)."""
    px = ts_x * ts_y
    loc = torch.arange(px, device=tile_ids.device)
    ox = (tile_ids.long() % tiles_x) * ts_x
    oy = torch.div(tile_ids.long(), tiles_x, rounding_mode="floor") * ts_y
    pu = (ox[:, None] + loc[None, :] % ts_x).to(torch.float32)
    pv = (oy[:, None] + torch.div(loc, ts_x, rounding_mode="floor")[None, :]).to(torch.float32)
    return pu, pv


def blend_tiles(
    packed: torch.Tensor,  # [T, 16, cap]
    counts: torch.Tensor,  # [T]
    pu: torch.Tensor,  # [T, px]
    pv: torch.Tensor,  # [T, px]
    K: int,
    exact: bool,
    crossing_median: bool,
    pairs: dict[str, int] | None = None,
    with_last: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The plain per-tile front-to-back blend, chunk by chunk.

    Returns ``out [T, 8, px]`` = (r, g, b, depth, alpha, median depth,
    final T, 0) and ``chunk_t [T, n_chunks + 1, px]`` (the incoming T of
    each chunk, 0 once the pixel is done; the last row is the final T);
    with ``with_last`` also ``last [T, px]`` int32, the slot of each pixel's
    last applied instance (-1 for none).
    ``crossing_median`` takes the median depth at the T=0.5 crossing (the
    tracking kernel's rule); otherwise the last applied instance with
    incoming T > 0.5 (the render kernel's). Differentiable w.r.t.
    ``packed`` except through the median depth.

    If ``pairs`` is a dict, it receives the (pixel, instance) pair counts
    of the kernels' per-pixel loop: ``evaluated`` (the falloff is computed),
    ``applied`` (the instance is blended) and ``to_last`` (the pairs up to
    each pixel's last applied instance, which a backward walks again)."""
    n_tiles, _, cap = packed.shape
    px = pu.shape[1]
    K = min(K, cap)
    n_chunks = cap // K
    dev = packed.device
    T = torch.ones((n_tiles, px), device=dev)
    acc = torch.zeros((n_tiles, 5, px), device=dev)
    Med = torch.zeros((n_tiles, px), device=dev)
    done = torch.zeros((n_tiles, px), dtype=torch.bool, device=dev)
    chunk_t = []
    kk = torch.arange(K, device=dev)
    n_eval = n_apply = 0
    n_last = torch.zeros((n_tiles, px), dtype=torch.long, device=dev)
    for c in range(n_chunks):
        done0 = done
        chunk_t.append(torch.where(done, torch.zeros_like(T), T))
        pk = packed[:, :, c * K:(c + 1) * K]  # [T, 16, K]
        row = lambda r: pk[:, r, None, :]  # [T, 1, K]
        live = (c * K + kk)[None, :] < counts[:, None]  # [T, K]
        d0 = row(MU) - pu[..., None]  # [T, px, K]
        d1 = row(MV) - pv[..., None]
        power = -0.5 * (row(CA) * d0 * d0 + row(CC) * d1 * d1) - row(CB) * d0 * d1
        alpha = torch.clamp(row(OP) * torch.exp(power), max=0.99)
        contrib = live[:, None, :] & (power <= 0.0) & (alpha >= MIN_ALPHA) & ~done[..., None]
        alpha = torch.where(contrib, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-alpha)
        T_pref = T[..., None] * torch.exp(torch.cumsum(log1m, dim=-1) - log1m)
        if exact:
            crosses = contrib & (T_pref * (1.0 - alpha) < STOP_T)
            n_cross = torch.cumsum(crosses.to(torch.int32), dim=-1)
            apply = contrib & ~(n_cross > 0)
            done = done | crosses.any(dim=-1)
            visited = n_cross - crosses.to(torch.int32) == 0
        else:
            apply = contrib & (T_pref >= STOP_T)
            visited = T_pref >= STOP_T
        if pairs is not None:
            visited = visited & live[:, None, :] & ~done0[..., None]
            n_eval += int(visited.sum())
            n_apply += int(apply.sum())
        if pairs is not None or with_last:
            idx = torch.where(apply, c * K + kk + 1, torch.zeros_like(kk)).amax(dim=-1)
            n_last = torch.maximum(n_last, idx)
        w = torch.where(apply, alpha * T_pref, torch.zeros_like(alpha))
        A = torch.cat([pk[:, R:Z + 1, :], torch.ones_like(pk[:, :1, :])], dim=1)  # [T, 5, K]
        acc = acc + torch.einsum("tpk,tak->tap", w, A)
        z = pk[:, Z, :].detach()
        if crossing_median:
            cross = apply & (T_pref > 0.5) & (T_pref * (1.0 - alpha) <= 0.5)
            Med = Med + torch.where(cross, z[:, None, :], torch.zeros_like(w)).sum(-1).detach()
        else:
            is_med = apply & (T_pref > 0.5)
            last = torch.where(is_med, kk + 1, torch.zeros_like(kk)).amax(dim=-1)  # [T, px]
            z_sel = torch.gather(z, 1, torch.clamp(last - 1, min=0))
            Med = torch.where(last > 0, z_sel, Med).detach()
        T = T * torch.exp(torch.where(apply, log1m, torch.zeros_like(log1m)).sum(-1))
        if not exact:
            done = done | (T < STOP_T)
    chunk_t.append(T)
    if pairs is not None:
        pairs.update(evaluated=n_eval, applied=n_apply, to_last=int(n_last.sum()))
    zero = torch.zeros_like(T)
    out = torch.cat([acc, torch.stack([Med, T, zero], dim=1)], dim=1)
    if with_last:
        return out, torch.stack(chunk_t, dim=1), (n_last - 1).to(torch.int32)
    return out, torch.stack(chunk_t, dim=1)


def _check_tile_shape(cfg: RasterConfig) -> None:
    px = cfg.tile_w_px * cfg.tile_h_px
    if px > MAX_TILE_PX or px % 32:
        raise ValueError(f"the blend kernels need tile pixels <= 256, a multiple of 32; got {px}")


def blend_forward_plain(
    packed: torch.Tensor,
    counts: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    pairs: dict[str, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: ``(out [T, 8, px], chunk_t [T, n_chunks+1, px])``;
    ``pairs`` as in :func:`blend_tiles`."""
    ty, tx = tile_grid_shape(cam, cfg)
    tile_ids = torch.arange(packed.shape[0], device=packed.device)
    pu, pv = tile_pixels(tile_ids, tx, cfg.tile_w_px, cfg.tile_h_px)
    return blend_tiles(packed, counts, pu, pv, cfg.chunk, cfg.exact_stop, False, pairs)


def blend_forward(
    packed: torch.Tensor, counts: torch.Tensor, cam: Camera, cfg: RasterConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: the per-tile forward blend. CUDA tensors launch the kernel, CPU
    tensors take :func:`blend_forward_plain`. Forward only: the kernel's
    backward (K6) is not ported, so a CUDA input that requires grad raises."""
    if not packed.is_cuda:
        return blend_forward_plain(packed, counts, cam, cfg)
    if torch.is_grad_enabled() and packed.requires_grad:
        raise NotImplementedError("the blend backward (K6) is not ported to CUDA yet")
    _check_tile_shape(cfg)
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles, _, cap = packed.shape
    K = min(cfg.chunk, cap)
    if n_tiles != ty * tx or cap % K:
        raise ValueError(f"packed {tuple(packed.shape)} does not fit the tile grid / chunk {K}")
    px = cfg.tile_w_px * cfg.tile_h_px
    n_chunks = cap // K
    dev = packed.device
    _build.check_tensor(packed, "packed", torch.float32, (n_tiles, N_ATTR, cap), dev)
    _build.check_tensor(counts, "counts", torch.int32, (n_tiles,), dev)
    out = torch.empty((n_tiles, 8, px), dtype=torch.float32, device=dev)
    chunk_t = torch.empty((n_tiles, n_chunks + 1, px), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch("blend_forward")
    err = lib.gsorb_blend_forward(
        packed.data_ptr(), counts.data_ptr(), out.data_ptr(), chunk_t.data_ptr(),
        n_tiles, cap, K, tx, cfg.tile_w_px, cfg.tile_h_px, int(cfg.exact_stop),
        _build.stream_handle(dev),
    )
    _build.check(err, "blend_forward")
    return out, chunk_t


def untile(a: torch.Tensor, cam: Camera, cfg: RasterConfig) -> torch.Tensor:
    """``[T, px, ...]`` tile-major -> ``[H, W, ...]`` image (cropped)."""
    ty, tx = tile_grid_shape(cam, cfg)
    tsx, tsy = cfg.tile_w_px, cfg.tile_h_px
    ch = a.shape[2:]
    a = a.reshape((ty, tx, tsy, tsx) + ch).transpose(1, 2)
    return a.reshape((ty * tsy, tx * tsx) + ch)[: cam.height, : cam.width]


def render_output_from_tiles(
    out: torch.Tensor, cam: Camera, cfg: RasterConfig, bg: float, radii: torch.Tensor
) -> RenderOutput:
    """Image-space :class:`RenderOutput` from blend rows ``[T, 8, px]``."""
    color = untile(out[:, 0:3].transpose(1, 2), cam, cfg)
    final_t = untile(out[:, 6], cam, cfg)
    return RenderOutput(
        color=color + final_t[..., None] * bg,
        depth=untile(out[:, 3], cam, cfg),
        alpha=untile(out[:, 4], cam, cfg),
        median_depth=untile(out[:, 5], cam, cfg).detach(),
        final_t=final_t,
        radii=radii,
    )


def blend_and_untile(
    packed: torch.Tensor,
    counts: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
    radii: torch.Tensor | None = None,
) -> RenderOutput:
    """Blend packed screen instances (K3 on CUDA) and reassemble the image."""
    out, _ = blend_forward(packed, counts, cam, cfg)
    if radii is None:
        radii = torch.zeros((packed.shape[0],), device=packed.device)
    return render_output_from_tiles(out, cam, cfg, bg, radii)


def render_kernel(
    prep: Preprocessed, bins: TileBins, cam: Camera, cfg: RasterConfig, bg: float = 0.0
) -> RenderOutput:
    """Pack the per-tile instances and blend them with K3 (or its plain
    version on the CPU); the counterpart of ``render_pallas``."""
    packed = pack_instances(prep, bins)
    return blend_and_untile(packed, bins.counts, cam, cfg, bg, radii=prep.radius)


def tile_gt_images(
    gt_color: torch.Tensor,  # [H, W, 3]
    gt_depth: torch.Tensor,  # [H, W]
    cam: Camera,
    cfg: RasterConfig,
) -> torch.Tensor:
    """Pack gt color + depth into the tile layout ``[T, 4, px]`` (r, g, b,
    depth). Padding pixels outside the image get depth 0, so the loss mask
    drops them."""
    ty, tx = tile_grid_shape(cam, cfg)
    tsx, tsy = cfg.tile_w_px, cfg.tile_h_px
    Hp, Wp = ty * tsy, tx * tsx
    img = torch.cat([gt_color, gt_depth[..., None]], dim=-1)  # [H, W, 4]
    img = torch.nn.functional.pad(img, (0, 0, 0, Wp - cam.width, 0, Hp - cam.height))
    img = img.reshape(ty, tsy, tx, tsx, 4).permute(0, 2, 4, 1, 3)  # [ty, tx, 4, tsy, tsx]
    return img.reshape(ty * tx, 4, tsy * tsx).contiguous()


def _tracking_args(packed, cfg, tile_ids):
    if cfg.exact_stop:
        raise NotImplementedError(
            "tracking with exact_stop=True (the exact fused kernel, K7) is not ported yet"
        )
    n_tiles, _, cap = packed.shape
    if tile_ids is None:
        tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=packed.device)
    return tile_ids, min(cfg.chunk, cap)


def tracking_loss_grad_plain(
    packed: torch.Tensor,
    counts: torch.Tensor,
    gt_tiles: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    tile_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's plain version: the fast-rule blend, the masked-sum L1 tracking
    loss (mask = alpha > 0.99 & gt depth > 0, fixed) and autograd to the
    packed instances. Returns ``(im_w * image_l1, depth_w * depth_l1,
    d_packed [T, 16, cap])``."""
    tile_ids, K = _tracking_args(packed, cfg, tile_ids)
    ty, tx = tile_grid_shape(cam, cfg)
    pu, pv = tile_pixels(tile_ids, tx, cfg.tile_w_px, cfg.tile_h_px)
    x = packed.detach().requires_grad_(True)
    with torch.enable_grad():
        out, _ = blend_tiles(x, counts, pu, pv, K, exact=False, crossing_median=True)
        gtd = gt_tiles[:, 3]
        mask = ((out[:, 4] > 0.99) & (gtd > 0)).to(torch.float32).detach()
        image_l1 = ((out[:, 0:3] - gt_tiles[:, 0:3]).abs() * mask[:, None]).sum()
        dpred = out[:, 5] if use_sur_depth else out[:, 3]
        depth_l1 = ((dpred - gtd).abs() * mask).sum()
        img = im_weight * image_l1
        dep = depth_weight * depth_l1
        (g,) = torch.autograd.grad(img + dep, x)
    return img.detach(), dep.detach(), g


def gt_without_loss_edges(
    packed: torch.Tensor,
    counts: torch.Tensor,
    gt_tiles: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, int]:
    """``gt_tiles`` with depth 0 at the pixels where the tracking loss is
    discontinuous within rounding, and their number.

    Those are the pixels whose blended alpha lies within ``eps`` of the 0.99
    mask threshold (the mask may flip) or whose color or depth residual lies
    within ``eps`` of 0 (the L1 sign may flip). A flip moves every gradient
    of the pixel by up to ``im_w * w``, so K1 and its plain version may
    disagree there by more than rounding; with depth 0 the pixels are out of
    the loss mask and both see the same signs and mask."""
    out, _ = blend_forward_plain(packed, counts, cam, cfg)
    edge = (out[:, 4] - 0.99).abs() < eps
    edge |= ((out[:, 0:3] - gt_tiles[:, 0:3]).abs() < eps).any(1)
    edge |= (out[:, 3] - gt_tiles[:, 3]).abs() < eps
    gt = gt_tiles.clone()
    gt[:, 3][edge] = 0.0
    return gt, int(edge.sum())


def tracking_loss_grad(
    packed: torch.Tensor,  # [T, 16, cap] screen instances
    counts: torch.Tensor,  # [T] int32
    gt_tiles: torch.Tensor,  # [T, 4, px] gt r, g, b, depth
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    tile_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: one fused tracking iteration -> ``(im_w * image_l1,
    depth_w * depth_l1, d_packed)``.

    ``tile_ids`` maps each row of ``packed``/``gt_tiles`` to its global tile
    id (the pixel origin); identity by default. CUDA tensors launch the
    kernel, CPU tensors take :func:`tracking_loss_grad_plain`."""
    if not packed.is_cuda:
        return tracking_loss_grad_plain(
            packed, counts, gt_tiles, cam, cfg, im_weight, depth_weight,
            use_sur_depth, tile_ids,
        )
    tile_ids, K = _tracking_args(packed, cfg, tile_ids)
    _check_tile_shape(cfg)
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles, _, cap = packed.shape
    if cap % K:
        raise ValueError(f"tile capacity {cap} is not a multiple of the chunk {K}")
    px = cfg.tile_w_px * cfg.tile_h_px
    dev = packed.device
    packed = packed.detach()
    _build.check_tensor(packed, "packed", torch.float32, (n_tiles, N_ATTR, cap), dev)
    _build.check_tensor(counts, "counts", torch.int32, (n_tiles,), dev)
    _build.check_tensor(tile_ids, "tile_ids", torch.int32, (n_tiles,), dev)
    _build.check_tensor(gt_tiles, "gt_tiles", torch.float32, (n_tiles, 4, px), dev)
    grads = torch.empty((n_tiles, N_ATTR, cap), dtype=torch.float32, device=dev)
    loss = torch.empty((n_tiles, 2), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch("fused_track_fast")
    err = lib.gsorb_fused_track_fast(
        packed.data_ptr(), counts.data_ptr(), tile_ids.data_ptr(), gt_tiles.data_ptr(),
        grads.data_ptr(), loss.data_ptr(), n_tiles, cap, K, tx, cfg.tile_w_px,
        cfg.tile_h_px, float(im_weight), float(depth_weight), int(bool(use_sur_depth)),
        _build.stream_handle(dev),
    )
    _build.check(err, "fused_track_fast")
    sums = loss.sum(0)
    return sums[0], sums[1], grads
