"""Tiled alpha-blend renderer (counterpart of ``gsorb_slam_tpu/raster/tiled.py``).

:func:`render_tiled` is the plain PyTorch blend over per-tile
fixed-capacity instance lists from :mod:`binning`: differentiable, on any
device, and the plain version the render kernel K3 is held against.
:func:`render_binned` dispatches by device: a CUDA tensor goes through K3
(``blend_kernels.render_kernel``), differentiable through its backward K6,
a CPU tensor through :func:`render_tiled`. Either way the pack gather's
backward sums each Gaussian's slots in a fixed order.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins, bin_gaussians
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    PackAux,
    blend_forward_plain,
    pack_instances,
    render_kernel,
    render_output_from_tiles,
)
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed, preprocess
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput


def render_tiled(
    prep: Preprocessed,
    bins: TileBins,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
    pack_aux: PackAux | None = None,
) -> RenderOutput:
    """Plain blend of the binned instances with ``cfg.exact_stop``
    semantics (median depth = last applied instance with T > 0.5);
    ``pack_aux`` as in :func:`render_binned`."""
    cap = bins.indices.shape[1]
    if cap % min(cfg.chunk, cap):
        raise ValueError("tile_capacity must be a multiple of chunk")
    out = blend_forward_plain(pack_instances(prep, bins, pack_aux), bins.counts, cam, cfg)[0]
    return render_output_from_tiles(out, cam, cfg, bg, prep.radius)


def render_binned(
    prep: Preprocessed,
    bins: TileBins,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
    pack_aux: PackAux | None = None,
) -> RenderOutput:
    """Device dispatcher: K3 (backward K6) for CUDA tensors,
    :func:`render_tiled` for CPU tensors. Both satisfy the same contract and
    are differentiable w.r.t. ``prep``. ``pack_aux`` is the pack's slot
    table for ``bins`` (``blend_kernels.tile_pack_grad_aux``), for a caller
    that differentiates many renders of the same bins; a differentiated
    render builds it when not given."""
    if prep.depth.is_cuda:
        return render_kernel(prep, bins, cam, cfg, bg, pack_aux)
    return render_tiled(prep, bins, cam, cfg, bg, pack_aux)


def render(
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig = RasterConfig(),
    bg: float = 0.0,
    scale_modifier: float = 1.0,
    bins: TileBins | None = None,
) -> RenderOutput:
    """One-shot render: preprocess -> (bin) -> blend, differentiable w.r.t.
    the splat parameters and the pose on either device. Fresh bins are built
    from a detached preprocess (binning is integer-valued)."""
    prep = preprocess(
        means, rgb, quats, logit_opacities, log_scales, active, T_cw, cam, scale_modifier
    )
    if bins is None:
        bins = bin_gaussians(prep.detach(), cam, cfg)
    return render_binned(prep, bins, cam, cfg, bg)
