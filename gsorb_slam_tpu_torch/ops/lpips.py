"""LPIPS with the AlexNet backbone, in PyTorch (counterpart of
``gsorb_slam_tpu/ops/lpips_jax.py``): the reference's TorchScript LPIPS
evaluation (``src/Utils.cc:373,440``, ``scripts/replay.py:20,341``).

Weights are not bundled (pretrained AlexNet and the LPIPS linear heads).
``scripts/export_lpips_weights.py`` writes ``lpips_alex.npz`` on a machine
with network access; point ``GSORB_LPIPS_WEIGHTS`` at it, or put it in this
package's ``assets/``.

Architecture (Zhang et al. 2018, lpips==0.1 'alex'):
  features = AlexNet's conv stack, tapped after relu1..relu5 (a 3x3 / 2
  max pool after relu1 and relu2);
  per layer: unit-normalize both images' features over the channels,
  squared difference, the 1x1 non-negative linear head, spatial mean;
  LPIPS = the sum over the 5 layers.
Input: ``[H, W, 3]`` in [0, 1], scaled to [-1, 1], then shifted and scaled
by the published constants.

The convolutions are cuDNN's on the card, so :func:`lpips_pair` pins full
f32 first (cuDNN's default TF32 keeps ~3 decimal digits).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from gsorb_slam_tpu_torch import _build

# lpips.networks.ScalingLayer constants (shift / scale of [-1, 1] inputs).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet's conv stack: (out channels, kernel, stride, pad), and the max
# pools that follow the relus.
_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (True, True, False, False, False)


def default_weights_path() -> str | None:
    """``GSORB_LPIPS_WEIGHTS`` if that file exists, else this package's
    ``assets/lpips_alex.npz`` if it exists, else None."""
    cand = os.environ.get("GSORB_LPIPS_WEIGHTS")
    if cand and os.path.exists(cand):
        return cand
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "lpips_alex.npz")
    return here if os.path.exists(here) else None


def load_lpips_weights(path: str, device: torch.device | str = "cuda") -> dict:
    """The exported npz (``conv{i}_w`` ``[kh, kw, cin, cout]``, ``conv{i}_b``
    ``[cout]``, ``lin{i}_w`` ``[cout]``, i in 0..4) as float32 tensors on
    ``device``, the convolution weights permuted once to ``[cout, cin, kh,
    kw]``."""
    z = np.load(path)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    w = {}
    for i in range(len(_CONVS)):
        w[f"conv{i}_w"] = t(z[f"conv{i}_w"]).permute(3, 2, 0, 1).contiguous()
        w[f"conv{i}_b"] = t(z[f"conv{i}_b"])
        w[f"lin{i}_w"] = t(z[f"lin{i}_w"])
    return w


def _features(imgs: torch.Tensor, w: dict) -> list[torch.Tensor]:
    """``[B, H, W, 3]`` in [0, 1] -> the 5 feature maps ``[B, c, h, w]``."""
    shift = imgs.new_tensor(_SHIFT)
    scale = imgs.new_tensor(_SCALE)
    x = ((imgs * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for i, (_cout, _k, stride, pad) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], stride=stride, padding=pad))
        feats.append(x)
        if _POOL_AFTER[i]:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_norm(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)


def lpips_pair(pred: torch.Tensor, target: torch.Tensor, w: dict) -> torch.Tensor:
    """LPIPS distance between two ``[H, W, 3]`` images in [0, 1], on their
    device (the weights' device)."""
    if pred.is_cuda:
        _build.pin_full_f32()
    with torch.no_grad():
        total = pred.new_zeros((), dtype=torch.float32)
        for i, f in enumerate(_features(torch.stack([pred, target]).float(), w)):
            n = _unit_norm(f)
            d = (n[0] - n[1]) ** 2  # [c, h, w]
            total = total + (d * w[f"lin{i}_w"][:, None, None]).sum(dim=0).mean()
    return total
