"""ORB feature extraction in PyTorch (counterpart of
``gsorb_slam_tpu/frontend/orb.py``).

The reference's ``ORBextractor`` (``src/ORBextractor.cc``: 8-level 1.2x
pyramid, two-threshold FAST-16 per cell, spatial balancing, intensity-
centroid orientation, 7x7 Gaussian blur, 256-pair steered rBRIEF) as dense
tensor math on the image's device: shifted comparisons, convolutions,
stable sorts and gathers. The spatial balancing is per-cell top responses
then a global top-k per level; :func:`quadtree_refine` restores the
reference's ``DistributeOctTree`` selection on the host.

Descriptors are ``int32 [N, 8]`` tensors holding the bit pattern of the
reference's 256-bit descriptors as eight 32-bit words (``torch.uint32``
supports few operations on CUDA); ``descriptors_to_numpy`` /
``descriptors_from_numpy`` convert to and from ``np.uint32``. The BRIEF
pattern is this package's own copy of the JAX package's
``brief_pattern.npy`` (the OpenCV ``bit_pattern_31_`` table, BSD-3).

The pyramid levels resample the full image with the antialiased triangle
weights of ``jax.image.resize(..., "linear")`` (a kernel widened by the
inverse scale, normalised per output sample), built once per level shape
as ``[h_l, H]`` and ``[w_l, W]`` matrices and applied as ``A @ img @ B.T``.
Ties between equal responses keep the lower index, as ``lax.top_k`` does.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gsorb_slam_tpu_torch.core.config import ORBConfig

EDGE = 19  # EDGE_THRESHOLD border exclusion (ORBextractor.cc)
PATCH_R = 15  # IC_Angle / descriptor patch radius (HALF_PATCH_SIZE)

# FAST-16 Bresenham circle offsets (dy, dx), clockwise from 12 o'clock.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


@functools.lru_cache(maxsize=1)
def _pattern() -> np.ndarray:
    return np.load(os.path.join(os.path.dirname(__file__), "brief_pattern.npy"))  # [256, 4]


def descriptors_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """``int32 [N, 8]`` descriptor words -> ``np.uint32`` with the same bits."""
    return desc.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def descriptors_from_numpy(desc: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """``np.uint32 [N, 8]`` descriptors -> ``int32`` words with the same bits."""
    return torch.as_tensor(np.ascontiguousarray(desc, np.uint32).view(np.int32), device=device)


def words_to_int32(w: torch.Tensor) -> torch.Tensor:
    """Integer words in ``[0, 2^32)`` -> ``int32`` with the same 32 bits."""
    return ((w.to(torch.int64) ^ 0x80000000) - 0x80000000).to(torch.int32)


class ORBFeatures(NamedTuple):
    """Padded per-frame features (capacity ``N``; ``valid`` marks real rows)."""

    uv: torch.Tensor  # [N, 2] level-0 pixel coords, undistorted when the
    #   camera has lens distortion (the reference's mvKeysUn)
    response: torch.Tensor  # [N]
    angle: torch.Tensor  # [N] radians
    octave: torch.Tensor  # [N] int32 pyramid level
    descriptors: torch.Tensor  # [N, 8] int32 words (256-bit rBRIEF)
    valid: torch.Tensor  # [N] bool
    uv_raw: Optional[torch.Tensor] = None  # [N, 2] raw (distorted) image
    #   coords (mvKeys), for image-space lookups only

    def count(self) -> int:
        return int(self.valid.sum())


def _fast_response(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-16/9 corner response map (0 where not a corner): the larger of
    the summed bright-arc and dark-arc differences past the threshold."""
    diffs = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) - img for dy, dx in _CIRCLE])
    bright = diffs > threshold
    dark = diffs < -threshold

    def has_arc9(m):
        a = m
        for s in range(1, 9):
            a = a & torch.roll(m, -s, dims=0)
        return a.any(0)

    is_corner = has_arc9(bright) | has_arc9(dark)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    sb = torch.where(bright, diffs - threshold, zero).sum(0)
    sd = torch.where(dark, -diffs - threshold, zero).sum(0)
    return torch.where(is_corner, torch.maximum(sb, sd), zero)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


@functools.lru_cache(maxsize=1)
def _ic_kernels() -> tuple[np.ndarray, np.ndarray]:
    """x- and y-weighted circular kernels for the intensity centroid."""
    r = PATCH_R
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    circ = (xs * xs + ys * ys) <= r * r
    return (xs * circ).astype(np.float32), (ys * circ).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _gauss7() -> np.ndarray:
    x = np.arange(7, dtype=np.float32) - 3
    g = np.exp(-(x**2) / (2 * 2.0**2))
    g /= g.sum()
    return np.outer(g, g)


def _conv2(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """``"SAME"`` cross-correlation with zero padding."""
    w = torch.as_tensor(k, device=img.device)[None, None]
    return F.conv2d(img[None, None], w, padding=k.shape[0] // 2)[0, 0]


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of ``jax.image.resize(..., "linear")``
    along one axis (``compute_weight_mat``): the triangle kernel widened by
    the inverse scale when downsampling, normalised per output sample, zero
    where the sample falls outside the input. As in the compiled JAX op, the
    sample positions ``(i + 0.5) * inv_scale - 0.5`` round once (a fused
    multiply-add) and the division by the kernel scale is a product with
    its float32 reciprocal: a sample position one ulp off moves a weight by
    ~3e-6 at VGA."""
    f32 = lambda v: float(np.float32(v))
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, 1.0)
    half = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    sample_f = (half.double() * inv_scale - 0.5).float()
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - (x * f32(1.0 / kernel_scale)).abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.contiguous()


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(img, (h, w), "linear")`` for a 2-D image."""
    A = resize_weights(img.shape[0], h, img.device)
    B = resize_weights(img.shape[1], w, img.device)
    return A @ img @ B.T


def _stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _extract_level(img: torch.Tensor, n_keep: int, ini_th: float, min_th: float,
                   cell: int = 32, per_cell: int = 8):
    """One pyramid level -> (uv [n_keep, 2], response, angle, desc, valid)."""
    H, W = img.shape
    dev = img.device
    border = torch.zeros((H, W), dtype=torch.bool, device=dev)
    border[EDGE:-EDGE, EDGE:-EDGE] = True

    r_ini = _nms3(_fast_response(img, ini_th)) * border
    r_min = _nms3(_fast_response(img, min_th)) * border

    # Two-threshold per-cell logic (ComputeKeyPointsOctTree): ini-threshold
    # detections where a cell has any, else min-threshold ones.
    Hc, Wc = H // cell, W // cell
    ri = r_ini[: Hc * cell, : Wc * cell].reshape(Hc, cell, Wc, cell)
    rm = r_min[: Hc * cell, : Wc * cell].reshape(Hc, cell, Wc, cell)
    has_ini = (ri > 0).any(dim=3, keepdim=True).any(dim=1, keepdim=True)
    r_cell = torch.where(has_ini, ri, rm)

    # Spatial balancing: per-cell top 'per_cell', then a global top n_keep.
    flat_cell = r_cell.permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)
    vals, idxs = _stable_topk(flat_cell, per_cell)
    cell_ids = torch.arange(Hc * Wc, dtype=torch.int64, device=dev)[:, None]
    py = ((cell_ids // Wc) * cell + idxs // cell).reshape(-1)
    px = ((cell_ids % Wc) * cell + idxs % cell).reshape(-1)
    top_vals, top_i = _stable_topk(vals.reshape(-1), min(n_keep, vals.numel()))
    ky, kx = py[top_i], px[top_i]
    valid = top_vals > 0

    # Orientation: the intensity centroid by two dense convolutions.
    kxk, kyk = _ic_kernels()
    angle = torch.atan2(_conv2(img, kyk)[ky, kx], _conv2(img, kxk)[ky, kx])

    # Blur, then steered BRIEF (OpenCV steering: x' = round(x cos - y sin),
    # y' = round(x sin + y cos)).
    blurred = _conv2(img, _gauss7())
    pat = torch.as_tensor(_pattern(), dtype=torch.float32, device=dev)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x1, y1, x2, y2 = (pat[:, i][None] for i in range(4))
    rx1 = torch.round(x1 * ca - y1 * sa).to(torch.int64) + kx[:, None]
    ry1 = torch.round(x1 * sa + y1 * ca).to(torch.int64) + ky[:, None]
    rx2 = torch.round(x2 * ca - y2 * sa).to(torch.int64) + kx[:, None]
    ry2 = torch.round(x2 * sa + y2 * ca).to(torch.int64) + ky[:, None]
    i1 = blurred[ry1.clamp(0, H - 1), rx1.clamp(0, W - 1)]
    i2 = blurred[ry2.clamp(0, H - 1), rx2.clamp(0, W - 1)]
    bits = (i1 < i2).to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    desc = words_to_int32((bits << shifts).sum(-1))
    uv = torch.stack([kx, ky], -1).to(torch.float32)
    return uv, top_vals, angle, desc, valid


def level_budgets(cfg: ORBConfig) -> np.ndarray:
    """Per-level feature budgets, the reference's geometric 1/scaleFactor
    distribution (``ORBextractor`` constructor), the last level taking the
    rest (at least 8)."""
    inv = 1.0 / cfg.scale_factor
    weights = np.array([inv**level for level in range(cfg.n_levels)])
    budgets = np.round(cfg.n_features * weights / weights.sum()).astype(int)
    budgets[-1] = max(cfg.n_features - budgets[:-1].sum(), 8)
    return budgets


def extract_orb(gray: torch.Tensor, cfg: ORBConfig = ORBConfig(),
                levels: Optional[list] = None) -> ORBFeatures:
    """Full pyramid extraction of ``gray [H, W]`` (float32 in [0, 1]) on its
    device; padded features of capacity ``cfg.n_features``. A ``levels``
    list receives the unblurred pyramid images ``[H_l, W_l]`` the
    extraction made (``ORBextractor::mvImagePyramid``), level 0 first."""
    H, W = gray.shape
    s = cfg.scale_factor
    budgets = level_budgets(cfg)
    uvs, rs, angs, descs, vals, octs = [], [], [], [], [], []
    img = gray
    for level in range(cfg.n_levels):
        scale = s**level
        if level > 0:
            img = resize_linear(gray, int(round(H / scale)), int(round(W / scale)))
        if levels is not None:
            levels.append(img)
        uv, r, a, d, v = _extract_level(img, int(budgets[level]), cfg.ini_th_fast / 255.0,
                                        cfg.min_th_fast / 255.0)
        uvs.append(uv * scale)
        rs.append(r)
        angs.append(a)
        descs.append(d)
        vals.append(v)
        octs.append(torch.full((uv.shape[0],), level, dtype=torch.int32, device=gray.device))
    uv = torch.cat(uvs)
    return ORBFeatures(uv=uv, response=torch.cat(rs), angle=torch.cat(angs),
                       octave=torch.cat(octs), descriptors=torch.cat(descs),
                       valid=torch.cat(vals), uv_raw=uv)


def quadtree_refine(feats: ORBFeatures, cfg: ORBConfig = ORBConfig(),
                    read: Callable[[torch.Tensor], torch.Tensor] = torch.Tensor.cpu
                    ) -> ORBFeatures:
    """The reference's ``DistributeOctTree`` selection over each level's
    candidates, by the native quad-tree (``frontend/native.py``) on the
    host: a level with more valid candidates than its budget keeps the
    quad-tree's choice. A failed build of the native library raises.
    ``read`` brings each field to the host (a caller may time it)."""
    from gsorb_slam_tpu_torch.frontend.native import quadtree_distribute

    valid = read(feats.valid).numpy().copy()
    uv = read(feats.uv).numpy()
    resp = read(feats.response).numpy()
    octv = read(feats.octave).numpy()
    inv = 1.0 / cfg.scale_factor
    weights = np.array([inv**level for level in range(cfg.n_levels)])
    budgets = np.round(cfg.n_features * weights / weights.sum()).astype(int)
    for level in range(cfg.n_levels):
        sel = np.nonzero(valid & (octv == level))[0]
        if len(sel) <= budgets[level]:
            continue
        keep = quadtree_distribute(uv[sel, 0], uv[sel, 1], resp[sel], int(budgets[level]))
        valid[sel[~keep]] = False
    return feats._replace(valid=torch.as_tensor(valid, device=feats.valid.device))


def level_sigma2(cfg: ORBConfig = ORBConfig()) -> np.ndarray:
    """Per-octave variance weights (``Frame::mvInvLevelSigma2``'s source)."""
    return np.array([(cfg.scale_factor**level) ** 2 for level in range(cfg.n_levels)],
                    np.float32)
