"""Photometric losses (counterpart of ``gsorb_slam_tpu/ops/losses.py``).

Image convention: channels-last ``[H, W, C]`` float32 in ``[0, 1]``; depth
maps are ``[H, W]``. The tracking loss lives here; SSIM and the mapping
losses come with the mapping path.
"""

from __future__ import annotations

import torch


def _align_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast an ``[H, W]`` mask over trailing channel dims of ``like``."""
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
