"""Image and depth quality metrics (counterpart of ``gsorb_slam_tpu/ops/metrics.py``).

PSNR (``src/Utils.cc:33-37``), 5-scale MS-SSIM with the standard weights
(the reference's TorchScript pytorch-msssim module) and the masked depth L1
(``scripts/replay.py:333-336``), in PyTorch on the device of the images.
SSIM is :func:`gsorb_slam_tpu_torch.ops.losses.ssim`. LPIPS needs AlexNet
weights the repository does not hold, so :func:`lpips` reports NaN.
"""

from __future__ import annotations

import math
import warnings

import torch

from gsorb_slam_tpu_torch.ops.losses import _depthwise_blur, ssim


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


def lpips(pred: torch.Tensor, target: torch.Tensor) -> float:
    """LPIPS (AlexNet): its weights are not in the repository, so this warns
    and reports NaN, as the JAX package does without them."""
    del pred, target
    warnings.warn("LPIPS weights unavailable; reporting NaN")
    return math.nan


__all__ = ["psnr", "ssim", "ms_ssim", "depth_l1", "lpips"]
