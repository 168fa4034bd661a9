"""The plain reference of the splat renderer, the tracking loss and the
mapping loss, written from the equations in plain PyTorch.

It imports nothing of the program: the semantics are those the
configuration states (the 3D Gaussian splatting tile renderer of the
source, ``forward.cu``) with the port's tiling as the configuration's
``raster`` block gives it:

- projection: EWA splatting with the 1.3 x tan(fov / 2) Jacobian clamp, a
  0.3 px low-pass on the 2D covariance, the near cull at z <= 0.2;
- tiles of ``tile`` px; a splat covers the tiles of its rectangle (radius
  ceil(3 sqrt(lambda_max)), tightened where opacity puts alpha under 1/255,
  plus ``dilate_px``), clamped to ``max_dup`` tiles around its own, and
  minus the tiles where its conic cannot reach alpha 1/255 (with a 1.44x
  margin on the quadratic); each tile's list is depth-sorted and cut at
  its capacity;
- blend, front to back: alpha = min(0.99, o exp(power)), skipped where
  power > 0 or alpha < 1/255; the fast stop rule applies a splat while the
  pixel's incoming transmittance is >= 1e-4;
- the median depth is the z at the T = 0.5 crossing (tracking) or of the
  last applied splat with incoming T > 0.5 (renders and mapping), with no
  gradient.

Matrix products are written as matrix products (``@``), so the precision
of the card's matmul unit is the reference's precision: full float32
unless TF32 is switched on, which is how the lower-precision control is
made (``slambench.lib.correctness``).

The blend runs over blocks of tiles, each padded to its longest list, and
under ``torch.utils.checkpoint`` when differentiated, so a full-width
frame fits beside the program's state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

NEAR = 0.2
LOW_PASS = 0.3
MIN_ALPHA = 1.0 / 255.0
STOP_T = 1e-4
BLOCK_ELEMS = 1 << 25  # (pixel, splat) pairs per blend block


@dataclass(frozen=True)
class Cam:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@dataclass(frozen=True)
class Tiling:
    tile: int
    capacity: int
    max_dup: int
    dilate_px: float


@dataclass
class Splats:
    """Map rows (``[N, ...]``) as the reference reads them."""

    means: torch.Tensor
    rgb: torch.Tensor
    quats: torch.Tensor
    logit_opacities: torch.Tensor
    log_scales: torch.Tensor
    active: torch.Tensor


@dataclass
class Screen:
    mean2d: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 3] (a, b, c) of the inverse 2D covariance
    depth: torch.Tensor  # [N]
    opacity: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternions ``[..., 4]`` (w, x, y, z) -> ``[..., 3, 3]``."""
    q = q / torch.clamp(q.norm(dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def pose_matrix(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=q.dtype, device=q.device)
    return torch.cat([torch.cat([quat_to_rot(q), t[:, None]], 1), bottom], 0)


def project(s: Splats, T_cw: torch.Tensor, cam: Cam, scale_modifier: float = 1.0,
            cull_screen: bool = True) -> Screen:
    """EWA projection of the splats at ``T_cw``. ``cull_screen`` also drops
    splats off the image or with opacity under 1/255 (a render's
    preprocessing); without it a splat is valid where it is live, in front
    and non-degenerate (the per-iteration projection of splats already in a
    tile list)."""
    R = T_cw[:3, :3]
    xc = s.means @ R.T + T_cw[:3, 3]
    z = xc[:, 2]
    in_front = z > NEAR
    sz = torch.where(in_front, z, torch.ones_like(z))
    tanx = cam.width / (2.0 * cam.fx)
    tany = cam.height / (2.0 * cam.fy)
    txz = torch.clamp(xc[:, 0] / sz, -1.3 * tanx, 1.3 * tanx)
    tyz = torch.clamp(xc[:, 1] / sz, -1.3 * tany, 1.3 * tany)
    Rg = quat_to_rot(s.quats)
    var = torch.exp(2.0 * s.log_scales) * scale_modifier ** 2
    cov_w = (Rg * var[:, None, :]) @ Rg.transpose(1, 2)
    cov_c = R @ cov_w @ R.T
    zero = torch.zeros_like(sz)
    J = torch.stack([
        torch.stack([cam.fx / sz, zero, -cam.fx / sz * txz], -1),
        torch.stack([zero, cam.fy / sz, -cam.fy / sz * tyz], -1),
    ], 1)  # [N, 2, 3]
    cov2 = J @ cov_c @ J.transpose(1, 2)
    a = cov2[:, 0, 0] + LOW_PASS
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + LOW_PASS
    det = a * c - b * b
    det_ok = det > 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    op = torch.sigmoid(s.logit_opacities)
    u = cam.fx * (xc[:, 0] / sz) + cam.cx
    v = cam.fy * (xc[:, 1] / sz) + cam.cy
    valid = s.active & in_front & det_ok
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        cutoff = torch.sqrt(2.0 * lam1 * torch.clamp(torch.log(torch.clamp(255.0 * op, min=1e-6)),
                                                     min=0.0))
        radius = torch.ceil(torch.minimum(3.0 * torch.sqrt(lam1), cutoff))
        if cull_screen:
            valid = valid & (u + radius > 0) & (u - radius < cam.width) & (v + radius > 0) \
                & (v - radius < cam.height) & (op >= MIN_ALPHA)
    return Screen(mean2d=torch.stack([u, v], -1), conic=conic,
                  depth=torch.where(valid, z, torch.full_like(z, float("inf"))), opacity=op,
                  color=s.rgb, radius=torch.where(valid, radius, torch.zeros_like(radius)),
                  valid=valid)


def grid(cam: Cam, tl: Tiling) -> tuple[int, int]:
    return -(-cam.height // tl.tile), -(-cam.width // tl.tile)


@torch.no_grad()
def tile_lists(sc: Screen, cam: Cam, tl: Tiling) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tile's splats, depth-sorted (ties by splat index) and cut at the
    tiling's capacity: ``(idx [T, capacity] int64, -1 past the count;
    counts [T])``."""
    ty, tx = grid(cam, tl)
    n_tiles = ty * tx
    D = tl.max_dup
    ts = float(tl.tile)
    u, v = sc.mean2d[:, 0], sc.mean2d[:, 1]
    r = sc.radius + tl.dilate_px
    x0 = torch.clamp(torch.floor((u - r) / ts), 0, tx).long()
    x1 = torch.clamp(torch.floor((u + r) / ts) + 1, 0, tx).long()
    y0 = torch.clamp(torch.floor((v - r) / ts), 0, ty).long()
    y1 = torch.clamp(torch.floor((v + r) / ts) + 1, 0, ty).long()
    cw = torch.clamp(x1 - x0, max=D)
    ch = torch.minimum(y1 - y0, torch.clamp(D // torch.clamp(cw, min=1), min=1))
    ctx = torch.clamp((u / ts).to(torch.int32).long(), 0, tx - 1)
    cty = torch.clamp((v / ts).to(torch.int32).long(), 0, ty - 1)
    sx = torch.minimum(torch.maximum(ctx - cw // 2, x0), torch.maximum(x1 - cw, x0))
    sy = torch.minimum(torch.maximum(cty - ch // 2, y0), torch.maximum(y1 - ch, y0))
    d = torch.arange(D, device=u.device)
    cw1 = torch.clamp(cw, min=1)[:, None]
    tx_i = sx[:, None] + d[None] % cw1
    ty_i = sy[:, None] + torch.div(d[None], cw1, rounding_mode="floor")
    ok = (d[None] < (cw * ch)[:, None]) & sc.valid[:, None]
    # Tiles the conic cannot reach at alpha 1/255 (minimum of the quadratic
    # over the dilated tile rectangle, 1.44x margin) are left out.
    dil = float(tl.dilate_px)
    ulo = tx_i.float() * ts - dil - u[:, None]
    uhi = ulo + ts + 2 * dil
    vlo = ty_i.float() * ts - dil - v[:, None]
    vhi = vlo + ts + 2 * dil
    A = torch.clamp(sc.conic[:, 0], min=1e-12)[:, None]
    B = sc.conic[:, 1][:, None]
    C = torch.clamp(sc.conic[:, 2], min=1e-12)[:, None]
    q = lambda du, dv: A * du * du + 2.0 * B * du * dv + C * dv * dv
    clip = lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)
    q_min = torch.minimum(
        torch.minimum(q(ulo, clip(-B * ulo / C, vlo, vhi)), q(uhi, clip(-B * uhi / C, vlo, vhi))),
        torch.minimum(q(clip(-B * vlo / A, ulo, uhi), vlo), q(clip(-B * vhi / A, ulo, uhi), vhi)))
    inside = (ulo <= 0) & (uhi >= 0) & (vlo <= 0) & (vhi >= 0)
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    q_max = 2.0 * torch.log(torch.clamp(255.0 * sc.opacity, min=1.0))[:, None]
    ok = ok & (q_min <= 1.44 * q_max)
    tile_id = torch.where(ok, ty_i * tx + tx_i, torch.full_like(tx_i, n_tiles)).reshape(-1)
    depth = torch.where(ok, sc.depth[:, None].expand(-1, D),
                        torch.full_like(tx_i, float("inf"), dtype=torch.float32)).reshape(-1)
    # (tile, depth) order, ties by splat index: the key packs both.
    order = torch.sort(depth, stable=True).indices
    order = order[torch.sort(tile_id[order], stable=True).indices]
    s_tile = tile_id[order]
    s_gid = torch.div(order, D, rounding_mode="floor")
    tid = torch.arange(n_tiles, device=u.device)
    starts = torch.searchsorted(s_tile, tid)
    ends = torch.searchsorted(s_tile, tid + 1)
    counts = torch.clamp(ends - starts, max=tl.capacity)
    k = torch.arange(tl.capacity, device=u.device)
    pos = torch.clamp(starts[:, None] + k[None], max=max(s_gid.numel() - 1, 0))
    idx = torch.where(k[None] < counts[:, None], s_gid[pos], torch.full_like(pos, -1))
    return idx, counts


def _tile_pixels(tiles: torch.Tensor, tx: int, ts: int) -> tuple[torch.Tensor, torch.Tensor]:
    loc = torch.arange(ts * ts, device=tiles.device)
    pu = ((tiles % tx) * ts)[:, None] + loc[None] % ts
    pv = (torch.div(tiles, tx, rounding_mode="floor") * ts)[:, None] \
        + torch.div(loc, ts, rounding_mode="floor")[None]
    return pu.float(), pv.float()


def _blend_block(attrs: torch.Tensor, live: torch.Tensor, pu: torch.Tensor, pv: torch.Tensor,
                 crossing: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Blend one block: ``attrs [B, K, 10]`` (u, v, a, b, c, opacity, r, g,
    b, z), ``live [B, K]``, pixels ``[B, P]`` -> ``(out [B, P, 7]`` = r, g,
    b, depth, alpha, median depth, final T; ``last [B, P]`` = 1 + the list
    position of the last applied splat, 0 for none)."""
    g = lambda i: attrs[:, None, :, i]  # [B, 1, K]
    d0 = g(0) - pu[..., None]
    d1 = g(1) - pv[..., None]
    power = -0.5 * (g(2) * d0 * d0 + g(4) * d1 * d1) - g(3) * d0 * d1
    alpha = torch.clamp(g(5) * torch.exp(power), max=0.99)
    contrib = live[:, None, :] & (power <= 0) & (alpha >= MIN_ALPHA)
    alpha = torch.where(contrib, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    T = torch.exp(torch.cumsum(log1m, -1) - log1m)
    apply = contrib & (T >= STOP_T)
    w = torch.where(apply, alpha * T, torch.zeros_like(alpha))
    vals = torch.cat([attrs[..., 6:10], torch.ones_like(attrs[..., :1])], -1)  # [B, K, 5]
    acc = torch.einsum("bpk,bkc->bpc", w, vals)
    z = attrs[..., 9].detach()[:, None, :].expand_as(w)
    Td = T.detach()
    if crossing:
        sel = apply & (Td > 0.5) & (Td * (1 - alpha.detach()) <= 0.5)
        med = torch.where(sel, z, torch.zeros_like(z)).sum(-1)
    else:
        k1 = torch.arange(1, w.shape[-1] + 1, device=w.device)
        last_med = torch.where(apply & (Td > 0.5), k1, torch.zeros_like(k1)).amax(-1)
        med = torch.where(last_med > 0, torch.gather(z, 2, (last_med - 1).clamp(min=0)[..., None])[..., 0],
                          torch.zeros_like(last_med, dtype=z.dtype))
    final_t = torch.exp(torch.where(apply, log1m, torch.zeros_like(log1m)).sum(-1))
    k1 = torch.arange(1, w.shape[-1] + 1, device=w.device)
    last = torch.where(apply, k1, torch.zeros_like(k1)).amax(-1)
    out = torch.cat([acc, med.detach()[..., None], final_t[..., None]], -1)
    return out, last


def _attrs(sc: Screen) -> torch.Tensor:
    vf = sc.valid.to(sc.opacity.dtype)
    return torch.cat([
        sc.mean2d, sc.conic * vf[:, None], (sc.opacity * vf)[:, None], sc.color,
        torch.where(sc.valid, sc.depth, torch.zeros_like(sc.depth))[:, None],
    ], -1)


def blend_tiles(sc: Screen, idx: torch.Tensor, counts: torch.Tensor, cam: Cam, tl: Tiling,
                crossing: bool, with_last: bool = False):
    """Blend every tile's list; returns ``out [T, P, 7]`` (and with
    ``with_last`` also ``last [T, P]``). Differentiable w.r.t. the screen
    attributes (the median depth carries no gradient)."""
    ty, tx = grid(cam, tl)
    attrs = _attrs(sc)
    n_tiles = ty * tx
    P = tl.tile * tl.tile
    outs = []
    lasts = []
    t0 = 0
    counts_h = counts.tolist()
    while t0 < n_tiles:
        t1 = t0
        kmax = 1
        while t1 < n_tiles:
            k_new = max(kmax, counts_h[t1])
            if t1 > t0 and (t1 - t0 + 1) * P * k_new > BLOCK_ELEMS:
                break
            kmax = k_new
            t1 += 1
        tiles = torch.arange(t0, t1, device=idx.device)
        bi = idx[t0:t1, :kmax]
        live = bi >= 0
        pu, pv = _tile_pixels(tiles, tx, tl.tile)

        def run(a, bi=bi, live=live, pu=pu, pv=pv):
            return _blend_block(a[bi.clamp(min=0)], live, pu, pv, crossing)

        if torch.is_grad_enabled() and attrs.requires_grad:
            o, last = checkpoint(run, attrs, use_reentrant=False)
        else:
            o, last = run(attrs)
        outs.append(o)
        lasts.append(last)
        t0 = t1
    out = torch.cat(outs, 0)
    return (out, torch.cat(lasts, 0)) if with_last else out


def untile(x: torch.Tensor, cam: Cam, tl: Tiling) -> torch.Tensor:
    """``[T, P, ...]`` -> ``[H, W, ...]``."""
    ty, tx = grid(cam, tl)
    ts = tl.tile
    rest = x.shape[2:]
    x = x.reshape((ty, tx, ts, ts) + rest).transpose(1, 2).reshape((ty * ts, tx * ts) + rest)
    return x[: cam.height, : cam.width]


def tile_image(img: torch.Tensor, cam: Cam, tl: Tiling) -> torch.Tensor:
    """``[H, W, ...]`` -> ``[T, P, ...]``, zero outside the image."""
    ty, tx = grid(cam, tl)
    ts = tl.tile
    pad = [0, 0] * (img.ndim - 2) + [0, tx * ts - cam.width, 0, ty * ts - cam.height]
    x = torch.nn.functional.pad(img, pad)
    rest = x.shape[2:]
    return x.reshape((ty, ts, tx, ts) + rest).transpose(1, 2).reshape((ty * tx, ts * ts) + rest)


def render(s: Splats, T_cw: torch.Tensor, cam: Cam, tl: Tiling, scale_modifier: float = 1.0,
           bins_from: Splats | None = None) -> dict[str, torch.Tensor]:
    """A render at ``T_cw``: images ``color [H, W, 3]``, ``depth``,
    ``alpha``, ``median`` (no gradient), ``final_t``. The tile lists come
    from ``bins_from`` (the map when its lists were built) or from ``s``."""
    sc = project(s, T_cw, cam, scale_modifier)
    with torch.no_grad():
        src = sc if bins_from is None else project(bins_from, T_cw, cam, scale_modifier)
        idx, counts = tile_lists(src, cam, tl)
    out = untile(blend_tiles(sc, idx, counts, cam, tl, crossing=False), cam, tl)
    return dict(color=out[..., 0:3], depth=out[..., 3], alpha=out[..., 4], median=out[..., 5],
                final_t=out[..., 6])


@torch.no_grad()
def pairs_to_last(s: Splats, T_cw: torch.Tensor, cam: Cam, tl: Tiling, crossing: bool,
                  scale_modifier: float = 1.0) -> tuple[int, int]:
    """(Σ over pixels of the list position of the last applied splat, Σ of
    the tile lists' lengths) at ``T_cw``: the (pixel, splat) pairs a blend
    must evaluate and the tile instances it must project, whatever walks
    them."""
    sc = project(s, T_cw, cam, scale_modifier)
    idx, counts = tile_lists(sc, cam, tl)
    sc2 = project(s, T_cw, cam, scale_modifier, cull_screen=False)
    _, last = blend_tiles(sc2, idx, counts, cam, tl, crossing=crossing, with_last=True)
    return int(last.sum()), int(counts.sum())


# --------------------------------------------------------------------- losses


def chi2(T_cw: torch.Tensor, obs_uv: torch.Tensor, world: torch.Tensor,
         inv_sigma2: torch.Tensor, cam: Cam) -> torch.Tensor:
    """Per-match chi^2 = invSigma2 ||project(T_cw X) - obs||^2."""
    xc = world @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = xc[:, 2]
    z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    du = cam.fx * xc[:, 0] / z + cam.cx - obs_uv[:, 0]
    dv = cam.fy * xc[:, 1] / z + cam.cy - obs_uv[:, 1]
    return inv_sigma2 * (du * du + dv * dv)


def tracking_instance_grads(s: Splats, q: torch.Tensor, t: torch.Tensor, bins_pose: torch.Tensor,
                            gt_color: torch.Tensor, gt_depth: torch.Tensor, cam: Cam, tl: Tiling,
                            w: dict, scale_modifier: float = 1.0):
    """The image and depth part of the tracking loss at pose (q, t), the
    lists built at ``bins_pose``, and its gradient with respect to each
    tile instance's screen attributes: ``(loss, d_inst [T, capacity, 10],
    counts [T])`` (u, v, conic a, b, c, opacity, r, g, b, z; zero past a
    tile's count). Tiles are independent, so each block is differentiated
    on its own."""
    with torch.no_grad():
        idx, counts = tile_lists(project(s, bins_pose, cam, scale_modifier), cam, tl)
        attrs = _attrs(project(s, pose_matrix(q, t), cam, scale_modifier, cull_screen=False))
    ty, tx = grid(cam, tl)
    gt = tile_image(torch.cat([gt_color, gt_depth[..., None]], -1), cam, tl)
    n_tiles, cap = idx.shape
    d_inst = torch.zeros((n_tiles, cap, attrs.shape[1]), device=attrs.device)
    total = torch.zeros((), dtype=torch.float64, device=attrs.device)
    P = tl.tile * tl.tile
    counts_h = counts.tolist()
    t0 = 0
    while t0 < n_tiles:
        t1, kmax = t0, 1
        while t1 < n_tiles:
            k_new = max(kmax, counts_h[t1])
            if t1 > t0 and (t1 - t0 + 1) * P * k_new > BLOCK_ELEMS:
                break
            kmax, t1 = k_new, t1 + 1
        bi = idx[t0:t1, :kmax]
        leaf = attrs[bi.clamp(min=0)].detach().requires_grad_(True)
        pu, pv = _tile_pixels(torch.arange(t0, t1, device=idx.device), tx, tl.tile)
        with torch.enable_grad():
            out, _ = _blend_block(leaf, bi >= 0, pu, pv, crossing=True)
            g = gt[t0:t1]
            mask = ((out[..., 4] > 0.99) & (g[..., 3] > 0)).to(out.dtype)
            dpred = out[..., 5] if w["use_sur_depth"] else out[..., 3]
            loss = (w["im_weight"] * ((out[..., 0:3] - g[..., 0:3]).abs() * mask[..., None]).sum()
                    + w["depth_weight"] * ((dpred - g[..., 3]).abs() * mask).sum())
            (gl,) = torch.autograd.grad(loss, leaf)
        d_inst[t0:t1, :kmax] = torch.where((bi >= 0)[..., None], gl, torch.zeros_like(gl))
        total += loss.detach().double()
        t0 = t1
    return total, d_inst, counts, idx


def pose_vjp(s: Splats, q: torch.Tensor, t: torch.Tensor, idx: torch.Tensor,
             d_inst: torch.Tensor, cam: Cam, scale_modifier: float = 1.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pose gradient that the screen-attribute cotangent ``d_inst``
    (``[T, capacity, 10]``, on the tile lists ``idx``) sends back through
    the per-instance projection at (q, t)."""
    q = q.detach().clone().requires_grad_(True)
    t = t.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        attrs = _attrs(project(s, pose_matrix(q, t), cam, scale_modifier, cull_screen=False))
        live = (idx >= 0)[..., None]
        inst = attrs[idx.clamp(min=0)]
        dot = (torch.where(live, inst * d_inst, torch.zeros_like(inst))).sum()
        gq, gt = torch.autograd.grad(dot, [q, t])
    return gq, gt


def _gauss_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] @ g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two ``[H, W, C]`` images, 11x11 Gaussian window (sigma
    1.5), valid convolution, C1 = 0.01^2, C2 = 0.03^2."""
    c = a.shape[-1]
    win = _gauss_window(device=a.device)[None, None].expand(c, 1, 11, 11)
    x = torch.stack([a, b, a * a, b * b, a * b]).permute(0, 3, 1, 2)  # [5, C, H, W]
    m = torch.nn.functional.conv2d(x, win, groups=c)
    mu_a, mu_b, m_aa, m_bb, m_ab = m.unbind(0)
    va, vb, cov = m_aa - mu_a ** 2, m_bb - mu_b ** 2, m_ab - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return s.mean()


def mapping_loss(s: Splats, scene_radius: torch.Tensor, T_cw: torch.Tensor,
                 gt_color: torch.Tensor, gt_depth: torch.Tensor, cam: Cam, tl: Tiling,
                 w: dict, bins_from: Splats, scale_modifier: float = 1.0) -> torch.Tensor:
    """The source's mapping loss on one frame (``src/Render.cc:420-483``):
    imW (lambda L1 + (1 - lambda)(1 - SSIM)) + depthW L1(depth) + surW
    L1(median depth, alpha > 0.99) + the two scale regularizers."""
    out = render(s, T_cw, cam, tl, scale_modifier, bins_from=bins_from)
    valid = gt_depth > 0

    def masked_l1(p, g, m):
        m = m.to(p.dtype)
        return ((p - g).abs() * m).sum() / torch.clamp(m.sum(), min=1.0)

    lam = w["lam"]
    image = lam * (out["color"] - gt_color).abs().mean()
    if lam != 1.0:
        image = image + (1 - lam) * (1 - ssim(out["color"], gt_color))
    depth = masked_l1(out["depth"], gt_depth, valid)
    sur = masked_l1(out["median"], gt_depth, valid & (out["alpha"] > 0.99))
    scales = torch.exp(s.log_scales)
    max_s = 0.1 * scene_radius
    w_row = (scales > max_s).sum(-1).to(scales.dtype) * s.active.to(scales.dtype)
    smax, smin = scales.amax(-1), scales.amin(-1)
    reg_scalar = (w_row * (smax - max_s)).sum()
    reg_long = (w_row * (smax - smin)).sum() / torch.clamp(w_row.sum(), min=1.0)
    return (w["im_weight"] * image + w["depth_weight"] * depth + w["sur_depth_weight"] * sur
            + w["reg_long_weight"] * reg_long + w["reg_scalar_weight"] * reg_scalar)


def psnr(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> float:
    """PSNR (dB, peak 1) over the masked pixels of ``[H, W, 3]`` images."""
    m = mask.to(pred.dtype)[..., None].expand_as(pred)
    mse = (((pred.clamp(0, 1) - gt) ** 2) * m).sum() / torch.clamp(m.sum(), min=1.0)
    return float(-10.0 * math.log10(max(float(mse), 1e-12)))
