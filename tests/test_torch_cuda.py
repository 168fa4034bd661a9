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
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess, render
from gsorb_slam_tpu_torch.raster.binning import chunk_layout, tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_backward,
    blend_backward_plain,
    blend_forward,
    blend_forward_plain,
    gt_without_loss_edges,
    pack_instances,
    tile_cotangent_without_gate_edges,
    tile_gt_images,
    tracking_loss_grad,
    tracking_loss_grad_plain,
)
from gsorb_slam_tpu_torch.raster.blend_kernels import flat_pack_grad_aux, render_output_from_tiles
from gsorb_slam_tpu_torch.raster.flat_kernels import (
    blend_flat_backward,
    blend_flat_backward_plain,
    blend_flat_forward,
    blend_flat_forward_plain,
    cotangent_without_gate_edges,
    pack_instances_flat,
    render_flat,
)
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix, screen_rows
from gsorb_slam_tpu_torch.raster.paired import (
    pack_gt_pairs,
    pair_bins,
    pair_gt_rows,
    tracking_loss_grad_paired,
    tracking_loss_grad_paired_plain,
    tracking_pair_order,
    unpack_gt_pairs,
)
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
        out_k, ct_k, _ = blend_forward(packed, bins.counts, CAM, cfg)
        assert _build.launches["blend_forward"] == n0 + 1
        out_p, ct_p, _ = blend_forward_plain(packed, bins.counts, CAM, cfg)
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

    gt_out = blend_forward_plain(pack_instances(prep, bins), bins.counts, CAM, CFG)[0]
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


def _gt_images(params, cam, cfg, dev):
    """A gt image pair: the scene rendered 1 cm to the side."""
    T = torch.eye(4, device=dev)
    T[0, 3] = 0.01
    prep = preprocess(*params, T, cam)
    bins = bin_gaussians(prep, cam, cfg)
    out = blend_forward_plain(pack_instances(prep, bins), bins.counts, cam, cfg)[0]
    rows = render_output_from_tiles(out, cam, cfg, 0.0, prep.radius)
    depth = torch.where(rows.alpha > 0.5, rows.median_depth, torch.zeros_like(rows.alpha))
    return rows.color.contiguous(), depth.contiguous()


@pytest.mark.parametrize("use_sur", [True, False])
def test_k7_matches_plain(dev, use_sur):
    """K7 (exact stop) against its plain version, with the blended-depth
    loss too (chip_smoke checks the median-depth loss)."""
    params = _scene(dev)
    cfg = dataclasses.replace(CFG, exact_stop=True)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, cfg)
    screen = pack_instances(prep, bins)
    gt4 = tile_gt_images(*_gt_images(params, CAM, cfg, dev), CAM, cfg)
    img_k, dep_k, _ = tracking_loss_grad(screen, bins.counts, gt4, CAM, cfg, 0.7, 1.0, use_sur)
    img_p, dep_p, _ = tracking_loss_grad_plain(screen, bins.counts, gt4, CAM, cfg, 0.7, 1.0,
                                               use_sur)
    torch.testing.assert_close(img_k + dep_k, img_p + dep_p, rtol=1e-3, atol=0)
    gt4, _ = gt_without_loss_edges(screen, bins.counts, gt4, CAM, cfg)
    n0 = _build.launches["fused_track_exact"]
    _, _, g_k = tracking_loss_grad(screen, bins.counts, gt4, CAM, cfg, 0.7, 1.0, use_sur)
    assert _build.launches["fused_track_exact"] == n0 + 1
    _, _, g_p = tracking_loss_grad_plain(screen, bins.counts, gt4, CAM, cfg, 0.7, 1.0, use_sur)
    torch.testing.assert_close(g_k, g_p, atol=8e-4, rtol=2e-3)


@pytest.mark.parametrize("paired_sort", [True, False])
def test_k8_matches_plain(dev, paired_sort):
    """K8 under both pairings (chip_smoke checks the count-sorted one)."""
    params = _scene(dev)
    cfg = dataclasses.replace(CFG, tile_h=8, paired=True, paired_sort=paired_sort)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, cfg)
    perm = tracking_pair_order(bins, CAM, cfg)
    pb = pair_bins(bins, perm)
    screen = pack_instances(prep, pb)
    color, depth = _gt_images(params, CAM, CFG, dev)
    gt = pack_gt_pairs(color, depth, CAM, cfg, perm)
    for use_sur in (True, False):
        img_k, dep_k, _ = tracking_loss_grad_paired(screen, pb.counts, gt, CAM, cfg, 0.7, 1.0,
                                                    use_sur, tile_ids=perm)
        img_p, dep_p, _ = tracking_loss_grad_paired_plain(screen, pb.counts, gt, CAM, cfg, 0.7,
                                                          1.0, use_sur, tile_ids=perm)
        torch.testing.assert_close(img_k + dep_k, img_p + dep_p, rtol=1e-3, atol=0)
    gt_e, _ = gt_without_loss_edges(screen, pb.counts, unpack_gt_pairs(gt), CAM, cfg,
                                    tile_ids=perm)
    gt_e = pair_gt_rows(gt_e)
    n0 = _build.launches["paired_track"]
    _, _, g_k = tracking_loss_grad_paired(screen, pb.counts, gt_e, CAM, cfg, 0.7, 1.0, True,
                                          tile_ids=perm)
    assert _build.launches["paired_track"] == n0 + 1
    _, _, g_p = tracking_loss_grad_paired_plain(screen, pb.counts, gt_e, CAM, cfg, 0.7, 1.0,
                                                True, tile_ids=perm)
    torch.testing.assert_close(g_k, g_p, atol=8e-4, rtol=2e-3)


@pytest.mark.parametrize("exact", [False, True])
def test_k6_matches_plain(dev, exact):
    """K6 against its plain version under a seeded random cotangent (rows
    0-4 and the final T), gate-edge pixels left out, and two launches
    bitwise equal."""
    params = _scene(dev)
    cfg = dataclasses.replace(CFG, exact_stop=exact)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, cfg)
    packed = pack_instances(prep, bins)
    out, chunk_t, last = blend_forward(packed, bins.counts, CAM, cfg)
    _, _, last_p = blend_forward_plain(packed, bins.counts, CAM, cfg)
    assert float((last != last_p).float().mean()) < 1e-3
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    g[:, 5] = g[:, 7] = 0.0
    g, _ = tile_cotangent_without_gate_edges(packed, g, CAM, cfg)
    n0 = _build.launches["blend_backward"]
    d_k = blend_backward(packed, bins.counts, chunk_t, last, g, CAM, cfg)
    assert _build.launches["blend_backward"] == n0 + 1
    d_p = blend_backward_plain(packed, bins.counts, g, CAM, cfg)
    torch.testing.assert_close(d_k, d_p, atol=8e-4, rtol=2e-3)
    assert torch.equal(blend_backward(packed, bins.counts, chunk_t, last, g, CAM, cfg), d_k)


def test_render_differentiates_through_k6(dev):
    """``render`` on CUDA tensors differentiates through K3 / K6 (it raised
    before K6 was ported): parameter gradients within 2e-2 of the CPU plain
    chain's, and a second backward bitwise equal (the pack's sorted
    backward)."""
    params = _scene(dev)
    names = ("means", "rgb", "quats", "logit_opacities", "log_scales")
    w = torch.rand((CAM.height, CAM.width, 3), generator=torch.Generator().manual_seed(4))

    def grads(device):
        ps = [p.detach().to(device).clone().requires_grad_(True) for p in params[:5]]
        out = render(*ps, params[5].to(device), torch.eye(4, device=device), CAM, CFG, bg=0.3)
        loss = (out.color * w.to(device)).sum() + out.depth.sum() + 0.5 * out.alpha.sum()
        return torch.autograd.grad(loss, ps)

    n0 = _build.launches["blend_backward"]
    g_k = grads(dev)
    assert _build.launches["blend_backward"] == n0 + 1
    for n, a, b in zip(names, g_k, grads("cpu")):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) < 2e-2, n
    assert all(torch.equal(a, b) for a, b in zip(g_k, grads(dev)))
