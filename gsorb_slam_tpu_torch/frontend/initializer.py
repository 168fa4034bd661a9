"""Two-view triangulation (counterpart of the part of
``gsorb_slam_tpu/frontend/initializer.py`` that the RGB-D local mapping
uses). The monocular bootstrap (``initialize_monocular``) belongs to the
monocular entry point and is not ported yet.
"""

from __future__ import annotations

import torch


def triangulate(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor,
                p2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of ``[N]`` point pairs (``[N, 2]`` pixels each)
    under projection matrices ``[3, 4]`` -> ``[N, 3]``, one batched SVD."""
    A = torch.stack([
        p1[:, 0, None] * P1[2] - P1[0],
        p1[:, 1, None] * P1[2] - P1[1],
        p2[:, 0, None] * P2[2] - P2[0],
        p2[:, 1, None] * P2[2] - P2[1],
    ], dim=1)  # [N, 4, 4]
    X = torch.linalg.svd(A).Vh[:, -1]
    w = X[:, 3]
    return X[:, :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)[:, None]
