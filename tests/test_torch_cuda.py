"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips. This file imports
neither jax nor the JAX package, so it runs on a machine with the card
only: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` skips ``tests/conftest.py``, which configures JAX).
Tolerances are those of ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.binning import chunk_layout, tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_forward,
    blend_forward_plain,
    gt_without_loss_edges,
    pack_instances,
    tracking_loss_grad,
    tracking_loss_grad_plain,
)
from gsorb_slam_tpu_torch.raster.blend_kernels import render_output_from_tiles
from gsorb_slam_tpu_torch.raster.flat_kernels import (
    blend_flat_backward,
    blend_flat_backward_plain,
    blend_flat_forward,
    blend_flat_forward_plain,
    cotangent_without_gate_edges,
    flat_pack_grad_aux,
    pack_instances_flat,
    render_flat,
)
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix, screen_rows
from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
    preprocess_bwd,
    preprocess_bwd_plain,
    preprocess_fwd,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

CAM = Camera(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
CFG = RasterConfig(tile=16, tile_capacity=512, max_dup=16, chunk=128, dilate_px=2.0,
                   exact_stop=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(dev, n=3000):
    rng = np.random.default_rng(0)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(0.8, 4.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    params = (
        means, rng.uniform(0, 1, (n, 3)).astype(np.float32), q,
        rng.uniform(0.0, 3.0, n).astype(np.float32),
        np.log(rng.uniform(0.01, 0.05, (n, 3))).astype(np.float32), np.ones(n, bool),
    )
    return tuple(torch.as_tensor(p, device=dev) for p in params)


def test_k3_matches_plain(dev):
    params = _scene(dev)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, CFG)
    packed = pack_instances(prep, bins)
    for exact in (False, True):
        cfg = dataclasses.replace(CFG, exact_stop=exact)
        n0 = _build.launches["blend_forward"]
        out_k, ct_k = blend_forward(packed, bins.counts, CAM, cfg)
        assert _build.launches["blend_forward"] == n0 + 1
        out_p, ct_p = blend_forward_plain(packed, bins.counts, CAM, cfg)
        torch.testing.assert_close(out_k, out_p, atol=2e-3, rtol=0)
        torch.testing.assert_close(ct_k, ct_p, atol=2e-3, rtol=0)


def test_k2_and_k1_match_plain(dev):
    params = _scene(dev)
    T0 = torch.eye(4, device=dev)
    prep = preprocess(*params, T0, CAM)
    bins = bin_gaussians(prep, CAM, CFG)
    raw = pack_raw_instances(*params, bins)
    rt = rt_from_matrix(pose_to_matrix(torch.tensor([1.0, 0.002, -0.001, 0.003], device=dev),
                                       torch.tensor([0.01, -0.004, 0.006], device=dev)))
    rt = rt.contiguous()
    screen = preprocess_fwd(raw, rt, CAM)
    torch.testing.assert_close(screen, screen_rows(raw, rt, CAM), atol=1e-4, rtol=1e-5)

    gt_out, _ = blend_forward_plain(pack_instances(prep, bins), bins.counts, CAM, CFG)
    # gt in the tile layout [T, 4, px]: rendered color, median depth where alpha > 0.5
    depth = torch.where(gt_out[:, 4:5] > 0.5, gt_out[:, 5:6], torch.zeros_like(gt_out[:, 5:6]))
    gt4 = torch.cat([gt_out[:, 0:3], depth], 1).contiguous()
    gt4, _ = gt_without_loss_edges(screen, bins.counts, gt4, CAM, CFG)
    for use_sur in (True, False):
        img_k, dep_k, g_k = tracking_loss_grad(screen, bins.counts, gt4, CAM, CFG, 0.7, 1.0,
                                               use_sur)
        img_p, dep_p, g_p = tracking_loss_grad_plain(screen, bins.counts, gt4, CAM, CFG, 0.7,
                                                     1.0, use_sur)
        torch.testing.assert_close(img_k + dep_k, img_p + dep_p, rtol=1e-3, atol=0)
        torch.testing.assert_close(g_k, g_p, atol=8e-4, rtol=2e-3)
    d_rt_k = preprocess_bwd(raw, rt, g_k, CAM)
    d_rt_p = preprocess_bwd_plain(raw, rt, g_k, CAM)
    assert float((d_rt_k - d_rt_p).abs().max() / d_rt_p.abs().max()) < 1e-3


def test_k5_exact_stop_with_background(dev):
    """K4 / K5 with the exact stop rule and a non-zero background (chip_smoke
    checks the fast rule with no background): K5 against its plain version,
    and parameter gradients through the sorted pack backward against the
    plain blend with autograd's scatter."""
    params = _scene(dev)
    cfg = dataclasses.replace(CFG, exact_stop=True)
    ty, tx = tile_grid_shape(CAM, cfg)
    means = params[0].clone().requires_grad_(True)
    prep = preprocess(means, *params[1:], torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep.detach(), CAM, cfg)
    cbins = chunk_layout(bins, ty * tx, cfg.chunk, 512)
    packed = pack_instances_flat(prep.detach(), cbins)
    out, chunk_t, last = blend_flat_forward(packed, cbins, CAM, cfg)
    out_p, chunk_t_p, last_p = blend_flat_forward_plain(packed, cbins, CAM, cfg)
    torch.testing.assert_close(out, out_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(chunk_t, chunk_t_p, atol=2e-3, rtol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    g[:, 5] = g[:, 7] = 0.0
    g, _ = cotangent_without_gate_edges(packed, cbins, g, CAM, cfg)
    n0 = _build.launches["blend_flat_bwd"]
    d_k = blend_flat_backward(packed, cbins, out, chunk_t, last, g, CAM, cfg)
    assert _build.launches["blend_flat_bwd"] == n0 + 1
    d_p = blend_flat_backward_plain(packed, cbins, g, CAM, cfg)
    torch.testing.assert_close(d_k, d_p, atol=8e-4, rtol=2e-3)

    bg, w = 0.3, torch.rand((CAM.height, CAM.width, 3), device=dev)
    aux = flat_pack_grad_aux(cbins.indices, means.shape[0])
    (g_k,) = torch.autograd.grad((render_flat(prep, cbins, CAM, cfg, bg, aux).color * w).sum(),
                                 means, retain_graph=True)
    out_p, _, _ = blend_flat_forward_plain(pack_instances_flat(prep, cbins), cbins, CAM, cfg)
    color_p = render_output_from_tiles(out_p, CAM, cfg, bg, prep.radius).color
    (g_p,) = torch.autograd.grad((color_p * w).sum(), means)
    assert float((g_k - g_p).abs().max() / g_p.abs().max()) < 2e-2
