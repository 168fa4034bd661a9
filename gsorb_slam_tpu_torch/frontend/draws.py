"""The RANSAC hypothesis draws of the frontend, in one replaceable place.

``ransac_pnp`` and ``ransac_sim3`` draw their sample indices through
:func:`draw_indices` (looked up on this module at each call), from a CPU
``torch.Generator`` seeded with the caller's ``seed``; a test can replace
the function to replay another generator's draws.
"""

from __future__ import annotations

import numpy as np
import torch


def draw_indices(seed: int, shape: tuple[int, ...], high: int) -> np.ndarray:
    """Integers uniform in ``[0, high)`` of ``shape`` (int64), a pure
    function of ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, int(high), tuple(shape), generator=gen).numpy()
