"""Photometric losses (counterpart of ``gsorb_slam_tpu/ops/losses.py``).

The reference's loss kit (``src/Utils.cc:33-120``): L1 variants with the
same reductions (mean for mapping, sum for tracking, masked variants), the
11x11 Gaussian-window SSIM and the mapping colour loss
``lambda * L1 + (1 - lambda) * (1 - SSIM)``.

Image convention: channels-last ``[H, W, C]`` float32 in ``[0, 1]``; depth
maps are ``[H, W]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_mapping(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean absolute error; masked mean if ``mask`` is given
    (``L1LossForMapping``, ``src/Utils.cc:39-45``)."""
    diff = (pred - target).abs()
    if mask is None:
        return diff.mean()
    mask = _align_mask(mask, diff)
    return (diff * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _align_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast an ``[H, W]`` mask over trailing channel dims of ``like``.

    A masked mean's denominator counts mask elements after the broadcast
    (an ``[H, W]`` mask over RGB counts 3 per pixel), as the reference's
    ``masked_select(...).mean()`` on a tiled mask does."""
    mask = mask.to(like.dtype)
    while mask.ndim < like.ndim:
        mask = mask[..., None]
    return mask.expand(like.shape)


def l1_tracking(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Sum absolute error (the tracking loss uses sums so per-pixel
    gradients do not shrink with resolution); ``L1LossForTracking``
    (``src/Utils.cc:47-52``)."""
    diff = (pred - target).abs()
    if mask is not None:
        diff = diff * _align_mask(mask, diff)
    return diff.sum()


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return g / np.sum(g)


def _depthwise_blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable depthwise Gaussian filter over ``[..., H, W, C]`` with valid
    padding: two 1-D grouped convolutions. On the card cuDNN runs them in
    full float32 with deterministic algorithms (``_build.library``)."""
    lead = img.shape[:-3]
    H, W, c = img.shape[-3:]
    x = img.reshape((-1, H, W, c)).permute(0, 3, 1, 2)  # [N, C, H, W]
    w = torch.as_tensor(_gaussian_window(size, sigma), dtype=img.dtype, device=img.device)
    x = torch.nn.functional.conv2d(x, w.reshape(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    x = torch.nn.functional.conv2d(x, w.reshape(1, 1, 1, size).expand(c, 1, 1, size), groups=c)
    return x.permute(0, 2, 3, 1).reshape(lead + x.shape[2:] + (c,))


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM over an ``[H, W, C]`` image with an 11x11 Gaussian window
    (``src/Utils.cc:81-120``), on the valid convolution output; ``mask``
    (``[H, W]``) applies to the SSIM map after the same crop."""
    if pred.ndim == 2:
        pred = pred[..., None]
        target = target[..., None]
    # The five blurred images in one batch.
    stack = torch.stack([pred, target, pred * pred, target * target, pred * target])
    mu_p, mu_t, mu_pp, mu_tt, mu_pt = _depthwise_blur(stack, window_size, sigma).unbind(0)
    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    )
    if mask is None:
        return ssim_map.mean()
    half = window_size // 2
    m = mask[half:-half, half:-half].to(ssim_map.dtype)[..., None].expand(ssim_map.shape)
    return (ssim_map * m).sum() / torch.clamp(m.sum(), min=1.0)


def mapping_image_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    lam: float = 0.8,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``lam * L1 + (1 - lam) * (1 - SSIM)``, the reference's mapping colour
    loss (``src/Render.cc:420-483``, ``Mapping.lambda``)."""
    return lam * l1_mapping(pred, target, mask) + (1.0 - lam) * (1.0 - ssim(pred, target, mask))


def scale_regularizers(
    log_scales: torch.Tensor,
    active: torch.Tensor,
    scene_radius: torch.Tensor | float,
    overshoot_frac: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anisotropy and absolute-size regularizers on Gaussian scales
    (``src/Render.cc:460-470``): mean (max - min) scale, and the mean
    overshoot beyond ``overshoot_frac * scene_radius``, over live splats."""
    scales = torch.exp(log_scales)
    w = active.to(scales.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    aniso = ((scales.amax(-1) - scales.amin(-1)) * w).sum() / denom
    limit = overshoot_frac * scene_radius
    overshoot = (torch.clamp(scales - limit, min=0.0) * w[:, None]).sum() / denom
    return aniso, overshoot
