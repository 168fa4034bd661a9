"""Dense reference renderer — the correctness oracle (counterpart of
``gsorb_slam_tpu/raster/naive.py``).

O(N * pixels) front-to-back alpha blending with the CUDA tile renderer's
semantics (``renderCUDA`` ``forward.cu:261-401``):

- alpha = min(0.99, opacity * exp(power)), skipped if power > 0 or
  alpha < 1/255,
- a pixel stops accepting contributions once ``T * (1-alpha) < 1e-4``
  (the contribution that would cross the threshold is NOT applied),
- median depth = z of the last contributor seen while ``T > 0.5``,
- ``out_color = C + T * bg``.

A Python loop over the depth-sorted Gaussians: for tests at small sizes.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch.core.camera import Camera, pixel_grid
from gsorb_slam_tpu_torch.raster.binning import gaussian_tile_rect
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput

MIN_ALPHA = 1.0 / 255.0
STOP_T = 1e-4


def render_naive(
    prep: Preprocessed,
    cam: Camera,
    bg: float = 0.0,
    cfg: RasterConfig = RasterConfig(),
) -> RenderOutput:
    order = torch.argsort(prep.depth, stable=True)  # +inf (culled) sorts last
    sx, sy, cw, ch = gaussian_tile_rect(prep, cam, cfg)
    dev = prep.depth.device
    uv = pixel_grid(cam, device=dev)  # [H, W, 2]
    ptx = (uv[..., 0] / cfg.tile_w_px).to(torch.int32)
    pty = (uv[..., 1] / cfg.tile_h_px).to(torch.int32)
    H, W = cam.height, cam.width
    T = torch.ones((H, W), device=dev)
    C = torch.zeros((H, W, 3), device=dev)
    D = torch.zeros((H, W), device=dev)
    S = torch.zeros((H, W), device=dev)
    Med = torch.zeros((H, W), device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for g in order.tolist():
        if not bool(prep.valid[g]):
            continue
        d = prep.mean2d[g] - uv
        con = prep.conic[g]
        power = -0.5 * (con[0] * d[..., 0] ** 2 + con[2] * d[..., 1] ** 2) - con[1] * d[
            ..., 0
        ] * d[..., 1]
        in_rect = (
            (ptx >= sx[g]) & (ptx < sx[g] + cw[g]) & (pty >= sy[g]) & (pty < sy[g] + ch[g])
        )
        alpha = torch.clamp(prep.opacity[g] * torch.exp(power), max=0.99)
        contrib = in_rect & (power <= 0.0) & (alpha >= MIN_ALPHA) & ~done
        test_T = T * (1.0 - alpha)
        crosses = contrib & (test_T < STOP_T)
        done = done | crosses
        apply = contrib & ~crosses
        w = torch.where(apply, alpha * T, torch.zeros_like(T))
        C = C + w[..., None] * prep.color[g]
        D = D + w * prep.depth[g]
        S = S + w
        Med = torch.where(apply & (T > 0.5), prep.depth[g], Med)
        T = torch.where(apply, test_T, T)
    return RenderOutput(
        color=C + T[..., None] * bg,
        depth=D,
        alpha=S,
        median_depth=Med.detach(),
        final_t=T,
        radii=prep.radius,
    )
