"""3-nearest-neighbour mean squared distance (counterpart of
``gsorb_slam_tpu/ops/knn.py``).

The splat scale initializers ``initScalarMethod`` 0 / 1
(``src/Gaussian.cc:59-72``) size each new splat by the mean squared
distance to its 3 nearest neighbours, the reference's
``simple_knn`` / ``distCUDA2`` (``src/simple_knn.cu:45-221``).

- :func:`knn3_mean_sq_dist` is the Morton-window approximation: sort the
  points by 30-bit Morton code and search +/- ``window`` neighbours of the
  sorted order. It runs on the tensors' device. At VGA it gathers
  ``[N, 64, 3]`` float32 for N = 307,200 candidate pixels (~236 MB).
- :func:`knn3_mean_sq_dist_exact` is the exact search the System's scale
  initializers use. It runs on the host through the native grid search
  (:mod:`gsorb_slam_tpu_torch.frontend.native`), as the JAX package runs
  it through ``jax.pure_callback``: the points go to the host and the
  result comes back to their device. It raises on a point set that is flat,
  or nearly so, along an axis, where the native search would not end in
  practice (:func:`_check_grid_walk`).
"""

from __future__ import annotations

import numpy as np
import torch

from gsorb_slam_tpu_torch.frontend import native

_MASK32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (Morton interleave helper).
    The JAX package multiplies ``uint32`` values with wrap-around; here the
    products run in int64 and are masked to 32 bits (every multiplier is at
    most 0x10001, so no product overflows int64)."""
    v = ((v * 0x00010001) & _MASK32) & 0xFF0000FF
    v = ((v * 0x00000101) & _MASK32) & 0x0F00F00F
    v = ((v * 0x00000011) & _MASK32) & 0xC30C30C3
    v = ((v * 0x00000005) & _MASK32) & 0x49249249
    return v


def morton_codes(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64 holding the uint32 values) of the points
    ``[N, 3]`` normalised to the valid points' bounding box."""
    valid = valid.to(torch.bool)
    inf = torch.full_like(pts, float("inf"))
    lo = torch.where(valid[:, None], pts, inf).amin(0)
    hi = torch.where(valid[:, None], pts, -inf).amax(0)
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((pts - lo) / span * 1023.0, 0, 1023).to(torch.int64)
    return _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)


def knn3_mean_sq_dist(pts: torch.Tensor, valid: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Mean squared distance to the (approximate) 3 nearest neighbours per
    point, searched within +/- ``window`` places of the Morton order; with
    fewer than 3 neighbours found, the nearest one's; invalid rows get 0."""
    valid = valid.to(torch.bool)
    n = pts.shape[0]
    dev = pts.device
    codes = torch.where(valid, morton_codes(pts, valid), torch.full_like(valid, _MASK32,
                                                                         dtype=torch.int64))
    # Stable, as jnp.argsort: equal codes keep their index order, which
    # decides who lands in whose window.
    order = torch.argsort(codes, stable=True)
    sorted_pts = pts[order]
    sorted_valid = valid[order]
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    ok = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    ok = ok & sorted_valid[idx]
    d2 = ((sorted_pts[idx] - sorted_pts[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    # Only the three smallest values are used, so the order among ties does
    # not matter.
    top3 = torch.topk(d2, 3, dim=1, largest=False, sorted=True).values
    mean3 = top3.mean(1)
    d1 = top3[:, 0]
    zero = torch.zeros_like(mean3)
    mean3 = torch.where(torch.isfinite(mean3), mean3, torch.where(torch.isfinite(d1), d1, zero))
    out = torch.empty_like(mean3)
    out[order] = mean3
    return torch.where(valid, out, zero)


# The most cells the native ring search may visit in one call, by
# _check_grid_walk's estimate: about 10-15 s on one host core.
MAX_GRID_VISITS = 1e10


def _check_grid_walk(pts: np.ndarray, valid: np.ndarray) -> None:
    """Raise where the native grid search (``native/gsorb_native.cpp:229-302``)
    would visit more than :data:`MAX_GRID_VISITS` cells.

    The search grids the valid points' box in cubes of side
    ``cell = cbrt(2 V / m)`` (each axis's extent clamped to 1e-9) and stops a
    query's ring walk only once the rings pass its 3rd neighbour in units of
    the narrowest grid cell. An axis whose extent is ``cell / q`` with
    ``q > 1`` gets one cell of that width, the neighbours lie about
    ``q^1.5`` such widths apart, and each query walks about ``2 q^6`` cells.
    An axis of zero extent (a fronto-parallel wall at the identity pose)
    gives q ~ 1e7: the walk runs to its 512-ring limit."""
    p = pts[valid].astype(np.float64)
    m = len(p)
    if m < 5:  # the native code brute-forces up to 4 points
        return
    ext = np.maximum(p.max(0) - p.min(0), 1e-9)
    cell = max(np.cbrt(np.prod(ext) * 2.0 / m), 1e-9)
    q = max(cell / ext.min(), 1.0)
    visits = m * 2.0 * q ** 6
    if visits > MAX_GRID_VISITS:
        raise ValueError(
            f"exact 3-NN: the {m} valid points are flat along an axis (extents {ext} m "
            f"against the native grid's {cell:.3g} m cells), so its ring search would visit "
            f"~{visits:.1e} cells; use initScalarMethod 2 for such a point set")


def knn3_mean_sq_dist_exact(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The exact 3-NN mean squared distance among the valid points (the
    ``src/simple_knn.cu:45-221`` contract) by the native grid search on the
    host; the result lands on ``pts``' device. Invalid rows get 0. Raises
    ValueError on a point set too flat for the grid search to end."""
    p = pts.detach().cpu().numpy()
    v = valid.detach().to(torch.bool).cpu().numpy()
    _check_grid_walk(p, v)
    return torch.from_numpy(native.exact_knn3_native(p, v)).to(pts.device)


__all__ = ["morton_codes", "knn3_mean_sq_dist", "knn3_mean_sq_dist_exact"]
