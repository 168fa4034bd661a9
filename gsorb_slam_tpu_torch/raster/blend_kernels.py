"""The per-tile blend kernels and their plain PyTorch versions (counterpart
of ``gsorb_slam_tpu/raster/pallas_raster.py`` for the tracking and render
path).

Three kernels live here, each beside a plain version of the same function:

- **K3** :func:`blend_forward` (``csrc/blend_forward.cu``), replacing the
  TPU per-tile forward blend ``_fwd_kernel``. Plain version:
  :func:`blend_forward_plain`.
- **K6** :func:`blend_backward` (``csrc/blend_backward.cu``), replacing its
  backward ``_bwd_kernel``. Plain version: :func:`blend_backward_plain`
  (``torch.autograd`` through the plain forward). :func:`blend` joins K3
  and K6 in a ``torch.autograd.Function``, so :func:`blend_and_untile`, and
  through it every per-tile render, is differentiable on CUDA.
- **K1** / **K7** :func:`tracking_loss_grad` (``csrc/fused_track.cu``),
  replacing the TPU fused tracking kernels ``_fused_track_kernel_fast``
  (fast stop, K1) and ``_fused_track_kernel_exact`` (``exact_stop=True``,
  K7): forward blend + masked L1 + cotangents + backward in one launch.
  Plain version: :func:`tracking_loss_grad_plain` (the same blend, the
  masked L1, and ``torch.autograd`` down to the packed instances).
- **K9** :func:`tracking_loss_grad_ablate` (``csrc/fused_track.cu``, K1's
  template with ablation switches), replacing the profiling copy of K1 in
  ``scripts/profile_fused_ablate.py``: K1's iteration over exactly
  :data:`ABLATE_CHUNKS` chunks per tile with no stop, in variants that
  switch parts off for timing. Plain version (``full`` and ``fwd`` only):
  :func:`tracking_loss_grad_ablate_plain`.

A wrapper launches its kernel for a CUDA tensor (or raises: there is no
fallback) and takes the plain version only for a tensor on the CPU.

The pack gather's backward (:class:`PackAux`) sums each Gaussian's slots in
a fixed order from a slot table, not with a float-atomic scatter
(``index_add_`` adds with atomics on CUDA), so a differentiated render, and
the map the multi-device mapping step writes, are bitwise reproducible.

The plain versions run the blend in :func:`blend_tiles`, which implements
the kernels' per-pixel stop rules exactly, so the on-card comparison is
tight: the fast rule applies an instance while the pixel's incoming
transmittance is >= 1e-4; the exact rule does not apply the instance whose
blend would take it below 1e-4.
"""

from __future__ import annotations

import dataclasses

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins, tile_grid_shape
from gsorb_slam_tpu_torch.raster.naive import MIN_ALPHA, STOP_T
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput
from gsorb_slam_tpu_torch.utils import trace

# Packed attribute rows (the opacity row is pre-multiplied by validity, so
# dead instances blend with alpha exactly 0).
MU, MV, CA, CB, CC, OP, R, G, B, Z, LIVE = range(11)
N_ATTR = 16
N_GRAD = 10  # d_mu, d_mv, d_ca, d_cb, d_cc, d_op, d_r, d_g, d_b, d_z
MAX_TILE_PX = 256  # threads per block of the blend kernels: one per pixel
ABLATE_CHUNKS = 2  # chunks per tile K9 walks, whatever the tile's count
ABLATE_VARIANTS = _build.ABLATE_VARIANTS


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


@dataclasses.dataclass
class PackAux:
    """Residuals of the pack gathers' backward (counterpart of
    ``flat_pack_grad_aux``): the gaussian id of every slot (C for dead
    slots) and ``table [C, L]``, the slots of each Gaussian in ascending
    order (from a stable sort of the slots by id), padded with the slot
    count (a zero row), L the most slots any Gaussian has."""

    flat_idx: torch.Tensor  # [n_slots] int64
    table: torch.Tensor  # [C, L] int64


def flat_pack_grad_aux(indices: torch.Tensor, C: int) -> PackAux:
    """Build :class:`PackAux` from slot indices (any shape, -1 dead) for a
    map of C rows (one host read for L)."""
    flat_idx = torch.where(indices < 0, torch.full_like(indices, C), indices).reshape(-1).long()
    n = flat_idx.numel()
    perm = torch.sort(flat_idx, stable=True).indices
    sorted_ids = flat_idx[perm]
    ids = torch.arange(C, device=indices.device)
    starts = torch.searchsorted(sorted_ids, ids)
    ends = torch.searchsorted(sorted_ids, ids, right=True)
    L = max(trace.wait(int, (ends - starts).max()) if C else 0, 1)
    pos = starts[:, None] + torch.arange(L, device=indices.device)[None, :]
    table = torch.where(pos < ends[:, None], perm[torch.clamp(pos, max=n - 1)],
                        torch.full_like(pos, n))
    return PackAux(flat_idx=flat_idx, table=table)


def tile_pack_grad_aux(bins: TileBins, C: int) -> PackAux:
    """:class:`PackAux` of the per-tile pack: the slots past each tile's
    count are dead (``pack_instances`` reads the sentinel row there)."""
    k = torch.arange(bins.indices.shape[1], device=bins.indices.device)
    live = k[None, :] < bins.counts[:, None]
    return flat_pack_grad_aux(torch.where(live, bins.indices, -1), C)


def sorted_segment_sum(g: torch.Tensor, aux: PackAux) -> torch.Tensor:
    """``d_cols [C + 1, 16]``: each Gaussian's slot rows of ``g [n_slots, 16]``
    summed in a fixed order (one gather through ``aux.table`` and a sum
    over its slots); the sentinel row C gets 0. Only the N_GRAD rows that
    carry gradients are summed."""
    gz = torch.cat([g[:, :N_GRAD], g.new_zeros((1, N_GRAD))], dim=0)
    d = gz[aux.table].sum(dim=1)  # [C, N_GRAD]
    out = g.new_zeros((aux.table.shape[0] + 1, g.shape[1]))
    out[:-1, :N_GRAD] = d
    return out


class _RowsGatherSorted(torch.autograd.Function):
    """``cols[aux.flat_idx]`` whose backward is :func:`sorted_segment_sum`."""

    @staticmethod
    def forward(ctx, cols, aux):
        ctx.aux = aux
        return cols[aux.flat_idx]

    @staticmethod
    def backward(ctx, g):
        return sorted_segment_sum(g.contiguous(), ctx.aux), None


def pack_instances(
    prep: Preprocessed, bins: TileBins, pack_aux: PackAux | None = None
) -> torch.Tensor:
    """Gather per-tile instance attributes into ``[T, 16, cap]``.

    Padding entries (``bins.indices == -1`` or past the tile's count) read
    the zero sentinel row of :func:`attr_cols`, so dead slots blend with
    opacity 0. When the attributes need a gradient, the gather's backward
    is the fixed-order :func:`sorted_segment_sum` (``pack_aux``, built here
    from ``bins`` if not given)."""
    T, cap = bins.indices.shape
    C = prep.depth.shape[0]
    cols = attr_cols(prep)
    if pack_aux is None and torch.is_grad_enabled() and cols.requires_grad:
        pack_aux = tile_pack_grad_aux(bins, C)
    if pack_aux is not None:
        rows = _RowsGatherSorted.apply(cols, pack_aux)
    else:
        k = torch.arange(cap, device=bins.indices.device)
        dead = (bins.indices < 0) | (k[None, :] >= bins.counts[:, None])
        idx = torch.where(dead, torch.full_like(bins.indices, C), bins.indices)
        rows = cols[idx.reshape(-1).long()]
    return rows.reshape(T, cap, N_ATTR).transpose(1, 2).contiguous()


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
    stop: bool = True,
    with_visit: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The plain per-tile front-to-back blend, chunk by chunk.

    Returns ``out [T, 8, px]`` = (r, g, b, depth, alpha, median depth,
    final T, 0) and ``chunk_t [T, n_chunks + 1, px]`` (the incoming T of
    each chunk, 0 once the pixel is done; the last row is the final T);
    with ``with_last`` also ``last [T, px]`` int32, the slot of each pixel's
    last applied instance (-1 for none); with ``with_visit`` also (last)
    ``visit [T, n_chunks, px / 32, ceil(K / 32)]`` int32, the visit words
    the kernels record: bit b of word j of warp w in chunk c is set iff
    some pixel 32 w .. 32 w + 31 applied slot 32 j + b of the chunk.
    ``crossing_median`` takes the median depth at the T=0.5 crossing (the
    tracking kernel's rule); otherwise the last applied instance with
    incoming T > 0.5 (the render kernel's). Differentiable w.r.t.
    ``packed`` except through the median depth. ``stop=False`` (fast rule
    only; K9's blend) applies every instance that passes the alpha gate,
    whatever the pixel's transmittance.

    If ``pairs`` is a dict, it receives the (pixel, instance) pair counts
    of the kernels' per-pixel loop: ``evaluated`` (the falloff is computed),
    ``applied`` (the instance is blended), ``to_last`` (the pairs up to
    each pixel's last applied instance) and ``warp_visits`` (the pairs the
    kernels' backward evaluates again: 32 x the distinct applied slots of
    each group of 32 consecutive pixels, a warp, which walks only those)
    and ``warp_kept`` (the pairs a forward evaluates whose warps walk only
    the slots :func:`footprint_keep` keeps, up to the slot where the warp's
    last lane stops: 32 x those (warp, slot) pairs; K3's and K4's walk)."""
    if exact and not stop:
        raise ValueError("the exact stop rule has no no-stop variant")
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
    n_eval = n_apply = n_visit = n_kept = 0
    n_last = torch.zeros((n_tiles, px), dtype=torch.long, device=dev)
    visit = []
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
        elif stop:
            apply = contrib & (T_pref >= STOP_T)
            visited = T_pref >= STOP_T
        else:
            apply = contrib
            visited = torch.ones_like(contrib)
        if pairs is not None:
            visited = visited & live[:, None, :] & ~done0[..., None]
            n_eval += int(visited.sum())
            n_apply += int(apply.sum())
            reach = _per_warp(visited)  # some lane of the warp is still blending
            n_kept += 32 * int((reach & footprint_keep(pk, pu, pv)).sum())
        if pairs is not None or with_last:
            idx = torch.where(apply, c * K + kk + 1, torch.zeros_like(kk)).amax(dim=-1)
            n_last = torch.maximum(n_last, idx)
        if pairs is not None or with_visit:
            warp_apply = _per_warp(apply)  # [T, px / 32, K]
            n_visit += 32 * int(warp_apply.sum())
            if with_visit:
                visit.append(_visit_words(warp_apply))
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
        if not exact and stop:
            done = done | (T < STOP_T)
    chunk_t.append(T)
    if pairs is not None:
        pairs.update(evaluated=n_eval, applied=n_apply, to_last=int(n_last.sum()),
                     warp_visits=n_visit, warp_kept=n_kept)
    zero = torch.zeros_like(T)
    res = (torch.cat([acc, torch.stack([Med, T, zero], dim=1)], dim=1), torch.stack(chunk_t, dim=1))
    if with_last:
        res += ((n_last - 1).to(torch.int32),)
    if with_visit:
        res += (torch.stack(visit, dim=1),)
    return res


def _per_warp(apply: torch.Tensor) -> torch.Tensor:
    """``[T, px, K]`` -> ``[T, px / 32, K]``: whether any pixel of each group
    of 32 consecutive pixels (a warp of the kernels) applied the slot."""
    n_tiles, px, K = apply.shape
    return apply.reshape(n_tiles, px // 32, 32, K).any(dim=2)


def _visit_words(warp_apply: torch.Tensor) -> torch.Tensor:
    """``[T, W, K]`` bool -> ``[T, W, ceil(K / 32)]`` int32 words, bit b of
    word j for slot 32 j + b (two's complement for bit 31)."""
    n_tiles, n_warps, K = warp_apply.shape
    pad = -K % 32
    a = torch.nn.functional.pad(warp_apply, (0, pad)) if pad else warp_apply
    bits = a.reshape(n_tiles, n_warps, (K + pad) // 32, 32).long()
    w = (bits << torch.arange(32, device=a.device)).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


# K3's and K4's footprint cull (csrc/common.cuh, slot_extents): a slot whose
# opacity is below FOOT_OP_MIN cannot pass the 1/255 gate anywhere (exp <= 1;
# the factor covers expf's and the product's rounding); otherwise its
# {alpha >= 1/255} ellipse d^T C d <= tau, tau = 2 ln(255 op), has the
# axis-aligned half-extents sqrt(tau cc / det), sqrt(tau ca / det). The f32
# falloff d^T C d is off by at most ~4e-7 of ca d0^2 + cc d1^2 + 2 |cb d0
# d1|, which is at most 2 (ca + cc)^2 / det times d^T C d: so tau is widened
# by that ratio times FOOT_Q_REL (twice the rounding), by FOOT_REL for logf
# and the gate, and the extents by FOOT_REL and FOOT_PAD_PX for sqrtf and
# the pixel offsets. A conic that is not positive definite, or whose
# widening exceeds a half, is never culled.
FOOT_OP_MIN = MIN_ALPHA * (1.0 - 1e-5)
FOOT_Q_REL = 2e-6
FOOT_REL = 1e-5
FOOT_PAD_PX = 1e-3


def footprint_extents(
    ca: torch.Tensor, cb: torch.Tensor, cc: torch.Tensor, op: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's and K4's per-slot half-extents ``(ex, ey)`` (float32, as the
    kernels compute them): -1 for a slot no pixel can apply, inf for one that
    cannot be bounded."""
    det = ca * cc - cb * cb
    tr = ca + cc
    rho = FOOT_Q_REL * tr * tr / det
    tau = (torch.clamp(2.0 * torch.log(255.0 * op), min=0.0) * (1.0 + FOOT_REL) + FOOT_REL) / (
        1.0 - rho)
    ex = torch.sqrt(tau * cc / det) * (1.0 + FOOT_REL) + FOOT_PAD_PX
    ey = torch.sqrt(tau * ca / det) * (1.0 + FOOT_REL) + FOOT_PAD_PX
    bounded = (ca > 0) & (cc > 0) & (det > 0) & (rho < 0.5)
    never = op < FOOT_OP_MIN
    inf = torch.full_like(ex, float("inf"))
    neg = torch.full_like(ex, -1.0)
    return (torch.where(never, neg, torch.where(bounded, ex, inf)),
            torch.where(never, neg, torch.where(bounded, ey, inf)))


def footprint_keep(packed: torch.Tensor, pu: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """``[T, px / 32, K]`` bool: the slots of ``packed [T, 16, K]`` whose
    footprint box meets the rectangle of pixel centres of each warp (32
    consecutive pixels of ``pu``, ``pv [T, px]``). K3 and K4 evaluate only
    these (lane, slot) pairs (K3 also only the slots below the tile's
    count); every pair that passes the gate is among them."""
    n_tiles, px = pu.shape
    ex, ey = footprint_extents(packed[:, CA], packed[:, CB], packed[:, CC], packed[:, OP])
    mu, mv = packed[:, MU, None, :], packed[:, MV, None, :]  # [T, 1, K]
    wu = pu.reshape(n_tiles, px // 32, 32)
    wv = pv.reshape(n_tiles, px // 32, 32)
    x0, x1 = wu.amin(-1)[..., None], wu.amax(-1)[..., None]  # [T, W, 1]
    y0, y1 = wv.amin(-1)[..., None], wv.amax(-1)[..., None]
    ex, ey = ex[:, None, :], ey[:, None, :]
    return ~((ex < 0) | (mu + ex < x0) | (mu - ex > x1) | (mv + ey < y0) | (mv - ey > y1))


def _check_tile_shape(cfg: RasterConfig) -> None:
    px = cfg.tile_w_px * cfg.tile_h_px
    if px > MAX_TILE_PX or px % 32:
        raise ValueError(f"the blend kernels need tile pixels <= 256, a multiple of 32; got {px}")


def _tile_grid_pixels(packed: torch.Tensor, cam: Camera, cfg: RasterConfig):
    ty, tx = tile_grid_shape(cam, cfg)
    tile_ids = torch.arange(packed.shape[0], device=packed.device)
    return tile_pixels(tile_ids, tx, cfg.tile_w_px, cfg.tile_h_px)


def blend_forward_plain(
    packed: torch.Tensor,
    counts: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    pairs: dict[str, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's plain version: ``(out [T, 8, px], chunk_t [T, n_chunks+1, px],
    last [T, px], visit [T, n_chunks, px / 32, ceil(K / 32)])`` as the
    kernel writes them (``visit`` as in :func:`blend_tiles`: zero for the
    chunks past a tile's count); ``pairs`` as in :func:`blend_tiles`."""
    pu, pv = _tile_grid_pixels(packed, cam, cfg)
    return blend_tiles(packed, counts, pu, pv, cfg.chunk, cfg.exact_stop, False, pairs,
                       with_last=True, with_visit=True)


def _words(K: int) -> int:
    """Visit words per warp and chunk: one per 32 slots."""
    return -(-K // 32)


def _tile_args(packed: torch.Tensor, counts: torch.Tensor, cam: Camera, cfg: RasterConfig):
    _check_tile_shape(cfg)
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles, _, cap = packed.shape
    K = min(cfg.chunk, cap)
    if n_tiles != ty * tx or cap % K:
        raise ValueError(f"packed {tuple(packed.shape)} does not fit the tile grid / chunk {K}")
    dev = packed.device
    _build.check_tensor(packed, "packed", torch.float32, (n_tiles, N_ATTR, cap), dev)
    _build.check_tensor(counts, "counts", torch.int32, (n_tiles,), dev)
    return n_tiles, tx, cap, K, cfg.tile_w_px * cfg.tile_h_px, dev


def blend_forward(
    packed: torch.Tensor,
    counts: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: the per-tile forward blend -> ``(out [T, 8, px], chunk_t
    [T, n_chunks + 1, px], last [T, px], visit [T, n_chunks, px / 32,
    ceil(K / 32)])``; the last three are K6's residuals: ``last`` the slot
    of each pixel's last applied instance (-1 for none), ``visit`` the
    visit words (int32; bit b of word j of warp w in chunk c is set iff one
    of the warp's 32 pixels applied slot c K + 32 j + b). The kernel writes
    every element of each. CUDA tensors launch the kernel, CPU tensors take
    :func:`blend_forward_plain`. Forward only: differentiate through
    :func:`blend`."""
    if not packed.is_cuda:
        return blend_forward_plain(packed, counts, cam, cfg)
    if torch.is_grad_enabled() and packed.requires_grad:
        raise ValueError("blend_forward is forward only: differentiate through blend")
    n_tiles, tx, cap, K, px, dev = _tile_args(packed, counts, cam, cfg)
    n_chunks = cap // K
    out = torch.empty((n_tiles, 8, px), dtype=torch.float32, device=dev)
    chunk_t = torch.empty((n_tiles, n_chunks + 1, px), dtype=torch.float32, device=dev)
    last = torch.empty((n_tiles, px), dtype=torch.int32, device=dev)
    visit = torch.empty((n_tiles, n_chunks, px // 32, _words(K)), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.count_launch("blend_forward")
    err = lib.gsorb_blend_forward(
        packed.data_ptr(), counts.data_ptr(), out.data_ptr(), chunk_t.data_ptr(),
        last.data_ptr(), visit.data_ptr(), n_tiles, cap, K, tx, cfg.tile_w_px, cfg.tile_h_px,
        int(cfg.exact_stop), _build.stream_handle(dev),
    )
    _build.check(err, "blend_forward")
    return out, chunk_t, last, visit


def blend_backward_plain(
    packed: torch.Tensor,  # [T, 16, cap]
    counts: torch.Tensor,
    g_out: torch.Tensor,  # [T, 8, px]
    cam: Camera,
    cfg: RasterConfig,
    tile_batch: int | None = None,
) -> torch.Tensor:
    """K6's plain version: ``torch.autograd`` through the plain forward ->
    ``grads [T, 16, cap]`` (rows 10-15 zero: the blend reads rows 0-9).
    ``tile_batch`` differentiates that many tiles at a time (the tiles blend
    independently), which bounds the memory the autograd graph holds at
    full width (all tiles of a VGA frame at capacity 2048 take several GB)."""
    pu, pv = _tile_grid_pixels(packed, cam, cfg)
    n_tiles = packed.shape[0]
    step = tile_batch or max(n_tiles, 1)
    pt = packed.detach()
    grads = torch.zeros_like(pt)
    with torch.enable_grad():
        for s in range(0, n_tiles, step):
            sl = slice(s, s + step)
            x = pt[sl].clone().requires_grad_(True)
            out, _ = blend_tiles(x, counts[sl], pu[sl], pv[sl], cfg.chunk, cfg.exact_stop, False)
            (grads[sl],) = torch.autograd.grad(out, x, g_out[sl])
    return grads


def blend_backward(
    packed: torch.Tensor,  # [T, 16, cap]
    counts: torch.Tensor,  # [T] int32
    chunk_t: torch.Tensor,  # [T, n_chunks + 1, px] from K3
    last: torch.Tensor,  # [T, px] from K3
    visit: torch.Tensor,  # [T, n_chunks, px / 32, ceil(K / 32)] from K3
    g_out: torch.Tensor,  # [T, 8, px] cotangent of K3's out
    cam: Camera,
    cfg: RasterConfig,
) -> torch.Tensor:
    """K6: the per-tile backward -> ``grads [T, 16, cap]`` (rows d_mu, d_mv,
    d_ca, d_cb, d_cc, d_op, d_r, d_g, d_b, d_z; rows 10-15 zero).
    ``chunk_t, last, visit`` are K3's residuals, in the order
    :func:`blend_forward` returns them; the median row of ``g_out`` is
    ignored. The kernel writes every element of ``grads``. CUDA tensors
    launch the kernel, CPU tensors take :func:`blend_backward_plain` (which
    needs none of the residuals)."""
    if not packed.is_cuda:
        return blend_backward_plain(packed, counts, g_out, cam, cfg)
    n_tiles, tx, cap, K, px, dev = _tile_args(packed, counts, cam, cfg)
    n_chunks = cap // K
    _build.check_tensor(chunk_t, "chunk_t", torch.float32, (n_tiles, n_chunks + 1, px), dev)
    _build.check_tensor(last, "last", torch.int32, (n_tiles, px), dev)
    _build.check_tensor(visit, "visit", torch.int32, (n_tiles, n_chunks, px // 32, _words(K)),
                        dev)
    _build.check_tensor(g_out, "g_out", torch.float32, (n_tiles, 8, px), dev)
    grads = torch.empty((n_tiles, N_ATTR, cap), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch("blend_backward")
    err = lib.gsorb_blend_backward(
        packed.data_ptr(), chunk_t.data_ptr(), last.data_ptr(), visit.data_ptr(),
        g_out.data_ptr(), grads.data_ptr(), n_tiles, cap, K, tx, cfg.tile_w_px,
        cfg.tile_h_px, _build.stream_handle(dev),
    )
    _build.check(err, "blend_backward")
    return grads


class _Blend(torch.autograd.Function):
    """K3 forward, K6 backward."""

    @staticmethod
    def forward(ctx, packed, counts, cam, cfg):
        out, chunk_t, last, visit = blend_forward(packed, counts, cam, cfg)
        ctx.save_for_backward(packed, counts, chunk_t, last, visit)
        ctx.cam, ctx.cfg = cam, cfg
        return out

    @staticmethod
    def backward(ctx, g_out):
        packed, counts, chunk_t, last, visit = ctx.saved_tensors
        grads = blend_backward(packed, counts, chunk_t, last, visit, g_out.contiguous(),
                               ctx.cam, ctx.cfg)
        return grads, None, None, None


def blend(
    packed: torch.Tensor, counts: torch.Tensor, cam: Camera, cfg: RasterConfig
) -> torch.Tensor:
    """The differentiable per-tile blend -> ``out [T, 8, px]``: K3 / K6 for
    CUDA tensors, autograd through the plain forward for CPU tensors. The
    median row carries no gradient."""
    if packed.is_cuda:
        return _Blend.apply(packed, counts, cam, cfg)
    return blend_forward_plain(packed, counts, cam, cfg)[0]


def gate_edges(
    packed: torch.Tensor, pu: torch.Tensor, pv: torch.Tensor, K: int, eps: float
) -> torch.Tensor:
    """``[T, px]`` bool: the pixels where some instance of the tile's
    ``packed [T, 16, cap]`` has an alpha within ``eps`` (relative) of the
    1/255 gate or of the 0.99 clamp (see
    :func:`tile_cotangent_without_gate_edges`)."""
    edge = torch.zeros_like(pu, dtype=torch.bool)
    for c in range(packed.shape[2] // K):
        pk = packed[:, :, c * K:(c + 1) * K]
        row = lambda r: pk[:, r, None, :]  # [T, 1, K]
        d0 = row(MU) - pu[..., None]
        d1 = row(MV) - pv[..., None]
        power = -0.5 * (row(CA) * d0 * d0 + row(CC) * d1 * d1) - row(CB) * d0 * d1
        raw = row(OP) * torch.exp(power)
        near = ((raw - MIN_ALPHA).abs() < eps * MIN_ALPHA) | ((raw - 0.99).abs() < eps * 0.99)
        edge |= (near & (power <= 0.0)).any(dim=-1)
    return edge


def tile_cotangent_without_gate_edges(
    packed: torch.Tensor,  # [T, 16, cap]
    g_out: torch.Tensor,  # [T, 8, px]
    cam: Camera,
    cfg: RasterConfig,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, int]:
    """``g_out`` with zeros at the pixels where the blend is discontinuous
    within rounding, and their number (the per-tile counterpart of
    ``flat_kernels.cotangent_without_gate_edges``).

    Those are the pixels where some instance of the tile has an alpha
    within ``eps`` (relative) of the 1/255 gate or of the 0.99 clamp: a
    kernel and its plain version (or the TPU kernel) may round to opposite
    sides there, which switches that instance's contribution on or off and
    moves the pixel's gradients by more than rounding. With a zero
    cotangent the pixel sends no gradient in either version."""
    pu, pv = _tile_grid_pixels(packed, cam, cfg)
    edge = gate_edges(packed.detach(), pu, pv, min(cfg.chunk, packed.shape[2]), eps)
    g = g_out.clone()
    g.masked_fill_(edge[:, None, :], 0.0)
    return g, int(edge.sum())


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
    """Blend packed screen instances (K3 on CUDA, differentiable through K6)
    and reassemble the image."""
    out = blend(packed, counts, cam, cfg)
    if radii is None:
        radii = torch.zeros((packed.shape[0],), device=packed.device)
    return render_output_from_tiles(out, cam, cfg, bg, radii)


def render_kernel(
    prep: Preprocessed,
    bins: TileBins,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
    pack_aux: PackAux | None = None,
) -> RenderOutput:
    """Pack the per-tile instances and blend them with K3 (or its plain
    version on the CPU); the counterpart of ``render_pallas``. Differentiable
    (K6 on CUDA; the pack's backward sums in a fixed order through
    ``pack_aux``, built from ``bins`` when not given)."""
    packed = pack_instances(prep, bins, pack_aux)
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
    n_tiles, _, cap = packed.shape
    if tile_ids is None:
        tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=packed.device)
    return tile_ids, min(cfg.chunk, cap)


def tracking_blend(
    packed: torch.Tensor,
    counts: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    tile_ids: torch.Tensor | None = None,
    pairs: dict[str, int] | None = None,
    stop: bool = True,
) -> torch.Tensor:
    """The blend rows ``[T, 8, px]`` the tracking kernels see: the fast rule
    with the T=0.5 crossing median, or with ``cfg.exact_stop`` the exact
    rule with the median of the last applied instance with incoming
    T > 0.5 (the TPU exact kernel's). ``pairs`` and ``stop`` as in
    :func:`blend_tiles`."""
    tile_ids, K = _tracking_args(packed, cfg, tile_ids)
    ty, tx = tile_grid_shape(cam, cfg)
    pu, pv = tile_pixels(tile_ids, tx, cfg.tile_w_px, cfg.tile_h_px)
    out, _ = blend_tiles(packed, counts, pu, pv, K, exact=cfg.exact_stop,
                         crossing_median=not cfg.exact_stop, pairs=pairs, stop=stop)
    return out


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
    stop: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's and K7's plain version: the blend of :func:`tracking_blend`, the
    masked-sum L1 tracking loss (mask = alpha > 0.99 & gt depth > 0, fixed)
    and autograd to the packed instances. Returns ``(im_w * image_l1,
    depth_w * depth_l1, d_packed [T, 16, cap])``. ``stop=False``: the blend
    without the transmittance stop (K9's)."""
    x = packed.detach().requires_grad_(True)
    with torch.enable_grad():
        out = tracking_blend(x, counts, cam, cfg, tile_ids, stop=stop)
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
    tile_ids: torch.Tensor | None = None,
    stop: bool = True,
) -> tuple[torch.Tensor, int]:
    """``gt_tiles`` (``[T, 4, px]``, one row per packed tile) with depth 0 at
    the pixels where the tracking loss is discontinuous within rounding, and
    their number. ``stop=False`` reads the blend without the stop (K9's:
    pass :func:`ablate_view`'s pack and counts).

    Those are the pixels whose blended alpha lies within ``eps`` of the 0.99
    mask threshold (the mask may flip) or whose color or depth residual lies
    within ``eps`` of 0 (the L1 sign may flip). A flip moves every gradient
    of the pixel by up to ``im_w * w``, so K1 and its plain version may
    disagree there by more than rounding; with depth 0 the pixels are out of
    the loss mask and both see the same signs and mask."""
    out = tracking_blend(packed, counts, cam, cfg, tile_ids, stop=stop)
    edge = (out[:, 4] - 0.99).abs() < eps
    edge |= ((out[:, 0:3] - gt_tiles[:, 0:3]).abs() < eps).any(1)
    edge |= (out[:, 3] - gt_tiles[:, 3]).abs() < eps
    gt = gt_tiles.clone()
    gt[:, 3][edge] = 0.0
    return gt, int(edge.sum())


def fused_track_launch(
    packed: torch.Tensor,  # [T, 16, cap] screen instances
    counts: torch.Tensor,  # [T] int32
    gt_tiles: torch.Tensor,  # [T, 4, px] gt r, g, b, depth
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    tile_ids: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1 (fast stop) or K7 (``cfg.exact_stop``) on CUDA
    tensors -> ``(loss [T, 2], d_packed [T, 16, cap])``: the kernel's
    per-tile rows of ``im_w * image_l1`` and ``depth_w * depth_l1`` and its
    gradient block, written into ``out`` if given (the kernel writes every
    element). :func:`tracking_loss_grad` sums the rows."""
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
    if out is not None:
        _build.check_tensor(out, "out", torch.float32, (n_tiles, N_ATTR, cap), dev)
    name = "fused_track_exact" if cfg.exact_stop else "fused_track_fast"
    return _launch_track(name, name, packed, counts, tile_ids, gt_tiles, K, tx, cfg, im_weight,
                         depth_weight, use_sur_depth, out)


def _launch_track(name, counter, packed, counts, tile_ids, gt_tiles, K, tx, cfg, im_weight,
                  depth_weight, use_sur_depth, out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``gsorb_<name>`` entry point of ``csrc/fused_track.cu`` on
    checked operands (``counts`` None for K9, which reads none), counted
    under ``counter`` -> ``(loss [T, 2], grads [T, 16, cap])``, ``grads``
    being ``out`` if given."""
    n_tiles, _, cap = packed.shape
    dev = packed.device
    grads = out
    if grads is None:
        grads = torch.empty((n_tiles, N_ATTR, cap), dtype=torch.float32, device=dev)
    loss = torch.empty((n_tiles, 2), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch(counter)
    err = getattr(lib, f"gsorb_{name}")(
        packed.data_ptr(), None if counts is None else counts.data_ptr(), tile_ids.data_ptr(),
        gt_tiles.data_ptr(), grads.data_ptr(), loss.data_ptr(), n_tiles, cap, K, tx,
        cfg.tile_w_px, cfg.tile_h_px, float(im_weight), float(depth_weight),
        int(bool(use_sur_depth)), _build.stream_handle(dev),
    )
    _build.check(err, name)
    return loss, grads


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
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 (fast stop) or K7 (``cfg.exact_stop``): one fused tracking
    iteration -> ``(im_w * image_l1, depth_w * depth_l1, d_packed)``.

    ``tile_ids`` maps each row of ``packed``/``gt_tiles`` to its global tile
    id (the pixel origin); identity by default. ``out`` (``[T, 16, cap]``
    float32), if given, receives ``d_packed`` and is returned as it. CUDA
    tensors launch the kernel (:func:`fused_track_launch`), CPU tensors take
    :func:`tracking_loss_grad_plain`."""
    if not packed.is_cuda:
        img, dep, g = tracking_loss_grad_plain(
            packed, counts, gt_tiles, cam, cfg, im_weight, depth_weight,
            use_sur_depth, tile_ids,
        )
        return img, dep, g if out is None else out.copy_(g)
    loss, grads = fused_track_launch(packed, counts, gt_tiles, cam, cfg, im_weight,
                                     depth_weight, use_sur_depth, tile_ids, out)
    sums = loss.sum(0)
    return sums[0], sums[1], grads


def ablate_view(packed: torch.Tensor, cfg: RasterConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The slots K9 walks: ``packed[:, :, :F K]`` (F = :data:`ABLATE_CHUNKS`)
    and a count of F K for every tile. Raises unless F K fits the capacity."""
    n_tiles, _, cap = packed.shape
    K = min(cfg.chunk, cap)
    if ABLATE_CHUNKS * K > cap or cap % K or K % 2:
        raise ValueError(f"K9 walks {ABLATE_CHUNKS} chunks of an even {K}; capacity {cap}")
    fk = ABLATE_CHUNKS * K
    counts = torch.full((n_tiles,), fk, dtype=torch.int32, device=packed.device)
    return packed[:, :, :fk], counts


def _check_variant(variant: str) -> None:
    if variant not in ABLATE_VARIANTS:
        raise ValueError(f"unknown K9 variant {variant!r}; one of {ABLATE_VARIANTS}")


def tracking_loss_grad_ablate_plain(
    packed: torch.Tensor,
    gt_tiles: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    variant: str = "full",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9's plain version for its ``full`` and ``fwd`` variants: K1's plain
    version over :func:`ablate_view`'s slots with no stop (fast rule, the
    T=0.5 crossing median) -> ``(im_w * image_l1, depth_w * depth_l1,
    d_packed [T, 16, cap])``, the gradient rows at and past F K zero and,
    for ``fwd``, all zero. The other variants are timing only and have no
    meaning here: they raise ``ValueError``."""
    _check_variant(variant)
    if variant not in ("full", "fwd"):
        raise ValueError(f"K9 variant {variant!r} is timing only: it runs on the card alone")
    if cfg.exact_stop:
        raise ValueError("K9 is K1's fast-rule iteration: exact_stop must be False")
    view, counts = ablate_view(packed, cfg)
    img, dep, g = tracking_loss_grad_plain(view, counts, gt_tiles, cam, cfg, im_weight,
                                           depth_weight, use_sur_depth, stop=False)
    grads = torch.zeros_like(packed)
    if variant == "full":
        grads[:, :, :view.shape[2]] = g
    return img, dep, grads


def fused_track_ablate_launch(
    packed: torch.Tensor,  # [T, 16, cap] screen instances
    gt_tiles: torch.Tensor,  # [T, 4, px] gt r, g, b, depth
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    variant: str = "full",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K9's ``variant`` on CUDA tensors -> ``(loss [T, 2],
    d_packed [T, 16, cap])``, as :func:`fused_track_launch` (row-major tiles
    of the whole grid; no counts: K9 walks F K slots of every tile)."""
    _check_variant(variant)
    if cfg.exact_stop:
        raise ValueError("K9 is K1's fast-rule iteration: exact_stop must be False")
    _check_tile_shape(cfg)
    ablate_view(packed, cfg)  # raises unless F K fits
    ty, tx = tile_grid_shape(cam, cfg)
    n_tiles, _, cap = packed.shape
    px = cfg.tile_w_px * cfg.tile_h_px
    dev = packed.device
    packed = packed.detach()
    _build.check_tensor(packed, "packed", torch.float32, (ty * tx, N_ATTR, cap), dev)
    _build.check_tensor(gt_tiles, "gt_tiles", torch.float32, (n_tiles, 4, px), dev)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    return _launch_track(f"fused_track_ablate_{variant}", "fused_track_ablate", packed, None,
                         tile_ids, gt_tiles, min(cfg.chunk, cap), tx, cfg, im_weight,
                         depth_weight, use_sur_depth)


def tracking_loss_grad_ablate(
    packed: torch.Tensor,
    gt_tiles: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    im_weight: float,
    depth_weight: float,
    use_sur_depth: bool,
    variant: str = "full",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9: K1's iteration over :data:`ABLATE_CHUNKS` chunks per tile with no
    stop, with parts switched off by ``variant`` -> ``(im_w * image_l1,
    depth_w * depth_l1, d_packed)``:

    - ``full``: the whole iteration (its math checked against
      :func:`tracking_loss_grad_ablate_plain`);
    - ``fwd``: the forward and the loss only (gradients zero);
    - ``noexp``: each exponential replaced by an FMA (timing only);
    - ``noreduce``: each per-instance sum over the tile's pixels replaced by
      one lane's value (timing only);
    - ``min``: ``noexp`` and ``noreduce`` together (timing only);
    - ``half2``: the forward falloff and alpha in ``__half2`` (timing only).

    CUDA tensors launch the kernel, CPU tensors take the plain version
    (``full`` and ``fwd`` only)."""
    if not packed.is_cuda:
        return tracking_loss_grad_ablate_plain(packed, gt_tiles, cam, cfg, im_weight,
                                               depth_weight, use_sur_depth, variant)
    loss, grads = fused_track_ablate_launch(packed, gt_tiles, cam, cfg, im_weight,
                                            depth_weight, use_sur_depth, variant)
    sums = loss.sum(0)
    return sums[0], sums[1], grads
