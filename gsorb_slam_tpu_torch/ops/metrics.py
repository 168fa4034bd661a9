"""Image and depth quality metrics (counterpart of ``gsorb_slam_tpu/ops/metrics.py``).

PSNR (``src/Utils.cc:33-37``), 5-scale MS-SSIM with the standard weights
(the reference's TorchScript pytorch-msssim module) and the masked depth L1
(``scripts/replay.py:333-336``), in PyTorch on the device of the images.
SSIM is :func:`gsorb_slam_tpu_torch.ops.losses.ssim`. :func:`lpips` is
:mod:`gsorb_slam_tpu_torch.ops.lpips` wherever its AlexNet weights exist,
else NaN (the repository does not hold them).
:func:`truncation_weight_report` says how much of the blended weight the
tile capacity's truncation removes.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.ops.losses import _depthwise_blur, ssim
from gsorb_slam_tpu_torch.raster.binning import bin_gaussians
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.tiled import render_binned
from gsorb_slam_tpu_torch.raster.types import RasterConfig


def psnr(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Peak signal-to-noise ratio over ``[H, W, C]`` images in [0, 1]; the
    reference masks evaluation pixels by valid depth (``mask`` ``[H, W]``)."""
    err = (pred - target) ** 2
    if mask is None:
        mse = err.mean()
    else:
        m = mask.to(err.dtype)[..., None].expand(err.shape)
        mse = (err * m).sum() / torch.clamp(m.sum(), min=1.0)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    x = img[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def ms_ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """5-scale MS-SSIM (Wang et al. 2003) over ``[H, W, C]`` images in [0, 1]."""
    levels = len(_MSSSIM_WEIGHTS)
    mcs = []
    p, t = pred, target
    value = torch.ones((), dtype=pred.dtype, device=pred.device)
    for i in range(levels):
        mu_p, mu_t = _depthwise_blur(p, window_size, sigma), _depthwise_blur(t, window_size, sigma)
        var_p = _depthwise_blur(p * p, window_size, sigma) - mu_p**2
        var_t = _depthwise_blur(t * t, window_size, sigma) - mu_t**2
        cov = _depthwise_blur(p * t, window_size, sigma) - mu_p * mu_t
        cs = ((2 * cov + c2) / (var_p + var_t + c2)).mean()
        if i < levels - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            p, t = _avg_pool2(p), _avg_pool2(t)
        else:
            lum = ((2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1)).mean()
            value = torch.clamp(lum * cs, min=0.0) ** _MSSSIM_WEIGHTS[-1]
    for w, cs in zip(_MSSSIM_WEIGHTS[:-1], mcs):
        value = value * cs**w
    return value


def depth_l1(
    pred_depth: torch.Tensor, gt_depth: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean |pred - gt| over valid-depth pixels."""
    if mask is None:
        mask = gt_depth > 0
    m = mask.to(pred_depth.dtype)
    return ((pred_depth - gt_depth).abs() * m).sum() / torch.clamp(m.sum(), min=1.0)


# The loaded LPIPS weights by (file, device); reset_lpips() empties it.
_LPIPS_MODEL: dict = {}


def reset_lpips() -> None:
    """Forget the loaded LPIPS weights (the next call looks them up anew)."""
    _LPIPS_MODEL.clear()


def lpips(pred: torch.Tensor, target: torch.Tensor) -> float:
    """LPIPS (AlexNet) between ``[H, W, 3]`` images in [0, 1], computed on
    ``pred``'s device with the weights of
    :func:`~gsorb_slam_tpu_torch.ops.lpips.default_weights_path`, loaded
    once per file and device. Without weights it warns and reports NaN, as
    the JAX package does without weights and without torchmetrics."""
    from gsorb_slam_tpu_torch.ops import lpips as LP

    path = LP.default_weights_path()
    if path is None:
        warnings.warn("LPIPS weights unavailable (set GSORB_LPIPS_WEIGHTS); reporting NaN")
        return math.nan
    pred = torch.as_tensor(pred, dtype=torch.float32)
    key = (path, pred.device)
    if key not in _LPIPS_MODEL:
        _LPIPS_MODEL[key] = LP.load_lpips_weights(path, pred.device)
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    return float(LP.lpips_pair(pred, target, _LPIPS_MODEL[key]))


def truncation_weight_report(
    prep: Preprocessed, cam: Camera, cfg: RasterConfig, oracle_capacity: int
) -> dict:
    """The blended-weight effect of the tile capacity's truncation: the
    same preprocessed scene rendered at ``cfg.tile_capacity`` and at
    ``oracle_capacity`` (large enough to drop nothing), and the share of
    accumulated opacity and color the truncation removed. Bins keep each
    tile's nearest instances, so the dropped ones are the farthest, occluded
    wherever the kept prefix saturates: the instance-count share
    (``inst_dropped_frac``) overstates the visible effect. Renders with K3
    on CUDA tensors, its plain version on CPU tensors."""
    cfg_o = dataclasses.replace(cfg, tile_capacity=int(oracle_capacity))
    with torch.no_grad():
        bins_t = bin_gaussians(prep, cam, cfg)
        bins_o = bin_gaussians(prep, cam, cfg_o)
        out_t = render_binned(prep, bins_t, cam, cfg)
        out_o = render_binned(prep, bins_o, cam, cfg_o)
    inst_total = float(bins_o.counts.sum())
    return {
        "inst_dropped_frac": float(bins_t.n_dropped) / max(inst_total, 1.0),
        "oracle_dropped": int(bins_o.n_dropped),  # 0 for a valid oracle
        "weight_dropped_frac": float((out_o.alpha - out_t.alpha).abs().sum())
        / max(float(out_o.alpha.sum()), 1e-9),
        "color_l1_frac": float((out_o.color - out_t.color).abs().sum())
        / max(float(out_o.color.abs().sum()), 1e-9),
        "depth_l1_mean_m": float((out_o.depth - out_t.depth).abs().mean()),
    }


__all__ = ["psnr", "ssim", "ms_ssim", "depth_l1", "lpips", "reset_lpips",
           "truncation_weight_report"]
