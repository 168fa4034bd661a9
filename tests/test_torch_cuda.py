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
from gsorb_slam_tpu_torch.ops import losses
from gsorb_slam_tpu_torch.profiling.common import (
    MAP_EDGE_KINDS,
    adjoint_edge_map,
    ssim_image_pair,
)
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess, render
from gsorb_slam_tpu_torch.raster.binning import TileBins, chunk_layout, tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_backward,
    blend_backward_plain,
    blend_forward,
    blend_forward_plain,
    gt_without_loss_edges,
    pack_instances,
    tile_cotangent_without_gate_edges,
    tile_gt_images,
    tile_pixels,
    tracking_blend,
    tracking_loss_grad,
    tracking_loss_grad_plain,
)
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    ABLATE_VARIANTS,
    ablate_view,
    flat_pack_grad_aux,
    render_output_from_tiles,
    tracking_loss_grad_ablate,
    tracking_loss_grad_ablate_plain,
)
from gsorb_slam_tpu_torch.raster.flat_kernels import (
    blend_flat_backward,
    blend_flat_backward_plain,
    blend_flat_forward,
    blend_flat_forward_plain,
    cotangent_without_gate_edges,
    footprint_keep_plain,
    pack_instances_flat,
    render_flat,
)
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix, screen_rows
from gsorb_slam_tpu_torch.raster.map_attr import (
    map_attr_table,
    map_attr_table_backward,
    map_attr_table_backward_plain,
    map_attr_table_forward,
    map_attr_table_plain,
)
from gsorb_slam_tpu_torch.raster.paired import (
    pack_gt_pairs,
    pair_bins,
    pair_gt_rows,
    tracking_loss_grad_paired,
    tracking_loss_grad_paired_plain,
    tracking_pair_order,
    unpack_gt_pairs,
)
from gsorb_slam_tpu_torch.slam.mapping import window_chunk_budget
from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
    adjoint_edge_pack,
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
    """K3 against its plain version under both stop rules: rows and chunk_t
    within 2e-3, the last applied slots and the visit words exactly."""
    params = _scene(dev)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, CFG)
    packed = pack_instances(prep, bins)
    for exact in (False, True):
        cfg = dataclasses.replace(CFG, exact_stop=exact)
        n0 = _build.launches["blend_forward"]
        out_k, ct_k, last_k, visit_k = blend_forward(packed, bins.counts, CAM, cfg)
        assert _build.launches["blend_forward"] == n0 + 1
        out_p, ct_p, last_p, visit_p = blend_forward_plain(packed, bins.counts, CAM, cfg)
        torch.testing.assert_close(out_k, out_p, atol=2e-3, rtol=0)
        torch.testing.assert_close(ct_k, ct_p, atol=2e-3, rtol=0)
        assert torch.equal(last_k, last_p)
        assert torch.equal(visit_k, visit_p) and bool(visit_k.any())


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


@pytest.mark.parametrize("n_tiles,cap", [(3, 300), (1, 256), (1, 300), (0, 300), (2, 150000)])
def test_k2b_edge_pack_matches_plain(dev, n_tiles, cap):
    """K2b on the adjoint's edge-case pack (near plane, clips, det <= 0, dead
    slots, zero cotangents) against its plain version, 1e-3 relative: at a
    capacity that is not a multiple of 256, at one tile of one block, at
    T = 0 (zeros) and past the grid's 1024 blocks (the grid-stride loop).
    One launch per call, and two launches give the same bits."""
    cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    raw, rt, d, _ = (torch.as_tensor(a).to(dev) for a in adjoint_edge_pack(0, n_tiles, cap, cam))
    n0 = _build.launches["preprocess_bwd"]
    d_k = preprocess_bwd(raw, rt, d, cam, 1.1)
    assert _build.launches["preprocess_bwd"] == n0 + 1
    d_p = preprocess_bwd_plain(raw, rt, d, cam, 1.1)
    if n_tiles == 0:
        assert not d_k.any() and not d_p.any()
    else:
        assert float((d_k - d_p).abs().max() / d_p.abs().max()) < 1e-3
    assert torch.equal(preprocess_bwd(raw, rt, d, cam, 1.1), d_k)


@pytest.mark.parametrize("exact", [False, True])
def test_k4_footprint_cull_keeps_visits(dev, exact):
    """K4 with its footprint cull on a mapping pack: rows within 2e-3 of
    the plain version's, the visit words equal to its words exactly, and
    every visited slot kept by the cull's plain version."""
    params = _scene(dev)
    cfg = dataclasses.replace(CFG, exact_stop=exact)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, cfg)
    ty, tx = tile_grid_shape(CAM, cfg)
    cbins = chunk_layout(bins, ty * tx, cfg.chunk, window_chunk_budget(bins.counts[None],
                                                                      cfg.chunk))
    packed = pack_instances_flat(prep, cbins)
    out, chunk_t, last, visit = blend_flat_forward(packed, cbins, CAM, cfg)
    out_p, chunk_t_p, last_p, visit_p = blend_flat_forward_plain(packed, cbins, CAM, cfg)
    torch.testing.assert_close(out, out_p, atol=5e-3, rtol=0)
    torch.testing.assert_close(chunk_t, chunk_t_p, atol=2e-3, rtol=0)
    assert torch.equal(visit, visit_p) and bool(visit.any())
    keep = footprint_keep_plain(packed, cbins, CAM, cfg)
    bits = ((visit.long() & 0xFFFFFFFF)[..., None] >> torch.arange(32, device=dev)) & 1
    applied = bits.reshape(*visit.shape[:2], -1)[..., :cfg.chunk].bool()
    assert not bool((applied & ~keep).any())
    assert torch.equal(blend_flat_forward(packed, cbins, CAM, cfg)[3], visit)


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
    out, chunk_t, last, visit = blend_flat_forward(packed, cbins, CAM, cfg)
    out_p, chunk_t_p, last_p, _ = blend_flat_forward_plain(packed, cbins, CAM, cfg)
    torch.testing.assert_close(out, out_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(chunk_t, chunk_t_p, atol=2e-3, rtol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    g[:, 5] = g[:, 7] = 0.0
    g, _ = cotangent_without_gate_edges(packed, cbins, g, CAM, cfg)
    n0 = _build.launches["blend_flat_bwd"]
    d_k = blend_flat_backward(packed, cbins, out, chunk_t, last, visit, g, CAM, cfg)
    assert _build.launches["blend_flat_bwd"] == n0 + 1
    d_p = blend_flat_backward_plain(packed, cbins, g, CAM, cfg)
    torch.testing.assert_close(d_k, d_p, atol=8e-4, rtol=2e-3)

    bg, w = 0.3, torch.rand((CAM.height, CAM.width, 3), device=dev)
    aux = flat_pack_grad_aux(cbins.indices, means.shape[0])
    (g_k,) = torch.autograd.grad((render_flat(prep, cbins, CAM, cfg, bg, aux).color * w).sum(),
                                 means, retain_graph=True)
    out_p = blend_flat_forward_plain(pack_instances_flat(prep, cbins), cbins, CAM, cfg)[0]
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


def test_k9_matches_plain(dev):
    """K9's ``full`` against its plain version (loss 1e-3 relative, gradient
    rows with the loss-edge pixels of the no-stop blend left out), two
    launches bitwise equal, ``fwd``'s loss rows equal to ``full``'s, and
    every variant finite. Capacity 512 at chunk 64: the fixed walk stops at
    slot 128, short of the fullest tiles."""
    params = _scene(dev)
    cfg = dataclasses.replace(CFG, chunk=64)
    prep = preprocess(*params, torch.eye(4, device=dev), CAM)
    bins = bin_gaussians(prep, CAM, cfg)
    screen = pack_instances(prep, bins)
    gt4 = tile_gt_images(*_gt_images(params, CAM, cfg, dev), CAM, cfg)
    fk = 2 * cfg.chunk
    assert int(bins.counts.max()) > fk
    for use_sur in (True, False):
        img_k, dep_k, _ = tracking_loss_grad_ablate(screen, gt4, CAM, cfg, 0.7, 1.0, use_sur)
        img_p, dep_p, _ = tracking_loss_grad_ablate_plain(screen, gt4, CAM, cfg, 0.7, 1.0,
                                                          use_sur)
        torch.testing.assert_close(img_k + dep_k, img_p + dep_p, rtol=1e-3, atol=0)
    view, counts_f = ablate_view(screen, cfg)
    gt_e, _ = gt_without_loss_edges(view, counts_f, gt4, CAM, cfg, stop=False)
    n0 = _build.launches["fused_track_ablate"]
    img_k, dep_k, g_k = tracking_loss_grad_ablate(screen, gt_e, CAM, cfg, 0.7, 1.0, True)
    assert _build.launches["fused_track_ablate"] == n0 + 1
    _, _, g_p = tracking_loss_grad_ablate_plain(screen, gt_e, CAM, cfg, 0.7, 1.0, True)
    torch.testing.assert_close(g_k, g_p, atol=8e-4, rtol=2e-3)
    assert not g_k[:, :, fk:].any()
    _, _, again = tracking_loss_grad_ablate(screen, gt_e, CAM, cfg, 0.7, 1.0, True)
    assert torch.equal(again, g_k)
    img_f, dep_f, g_f = tracking_loss_grad_ablate(screen, gt_e, CAM, cfg, 0.7, 1.0, True,
                                                  variant="fwd")
    assert float(img_f) == float(img_k) and float(dep_f) == float(dep_k) and not g_f.any()
    for v in ABLATE_VARIANTS:
        img, dep, g = tracking_loss_grad_ablate(screen, gt_e, CAM, cfg, 0.7, 1.0, True, variant=v)
        assert bool(torch.isfinite(img + dep)) and bool(torch.isfinite(g).all()), v


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
    out, chunk_t, last, visit = blend_forward(packed, bins.counts, CAM, cfg)
    _, _, last_p, _ = blend_forward_plain(packed, bins.counts, CAM, cfg)
    assert float((last != last_p).float().mean()) < 1e-3
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    g[:, 5] = g[:, 7] = 0.0
    g, _ = tile_cotangent_without_gate_edges(packed, g, CAM, cfg)
    n0 = _build.launches["blend_backward"]
    d_k = blend_backward(packed, bins.counts, chunk_t, last, visit, g, CAM, cfg)
    assert _build.launches["blend_backward"] == n0 + 1
    d_p = blend_backward_plain(packed, bins.counts, g, CAM, cfg)
    torch.testing.assert_close(d_k, d_p, atol=8e-4, rtol=2e-3)
    assert torch.equal(blend_backward(packed, bins.counts, chunk_t, last, visit, g, CAM, cfg),
                       d_k)


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


# ---- the visit words of K1 / K7 / K8 and K4 / K5 ----
#
# A synthetic pack at capacity 512, chunk 256, one tile of each kind:
#   full      count == capacity, random splats: pixels stop in different
#             words, some past the chunk boundary;
#   straddle  four splats covering the tile at slots 31, 32, 255 and 256
#             (across a word and across the chunk boundary), the other
#             live slots dead (opacity 0);
#   single    one pixel applies slot 37 (a splat too narrow to reach its
#             neighbours), every pixel a wide splat at slot 100;
#   empty     count == 0.
WORD_CAP = 512
WORD_K = 256


def _word_pack(dev, kinds, tile_ids, ts_y, tiles_x=2, seed=0):
    gen = np.random.default_rng(seed)
    pk = np.zeros((len(kinds), 16, WORD_CAP), np.float32)
    counts = np.zeros(len(kinds), np.int32)

    def splat(t, s, u, v, sigma, op):
        pk[t, 0:6, s] = (u, v, 1.0 / sigma ** 2, 0.0, 1.0 / sigma ** 2, op)

    for t, (kind, tid) in enumerate(zip(kinds, tile_ids)):
        ox, oy = (tid % tiles_x) * 16, (tid // tiles_x) * ts_y
        cx, cy = ox + 7.5, oy + ts_y / 2 - 0.5
        if kind == "full":
            n = WORD_CAP
            for s in range(n):
                splat(t, s, ox + gen.uniform(-4, 20), oy + gen.uniform(-4, ts_y + 4),
                      gen.uniform(1.5, 4.0), gen.uniform(0.05, 0.4))
        elif kind == "straddle":
            n = 300
            for s in (31, 32, 255, 256):
                splat(t, s, cx, cy, 12.0, 0.8)
        elif kind == "single":
            n = 120
            splat(t, 37, ox + 3, oy + 5, 1.0 / np.sqrt(20.0), 0.95)
            splat(t, 100, cx, cy, 12.0, 0.99)
        else:
            n = 0
        counts[t] = n
        pk[t, 6:9, :n] = gen.uniform(0.1, 1.0, (3, n))
        pk[t, 9, :n] = 1.0 + 0.01 * np.arange(n)
        pk[t, 10, :n] = 1.0
    return torch.as_tensor(pk, device=dev), torch.as_tensor(counts, device=dev)


def _word_gt(dev, n_tiles, px, seed=1):
    gen = np.random.default_rng(seed)
    gt = np.concatenate([gen.uniform(0, 1, (n_tiles, 3, px)), np.full((n_tiles, 1, px), 1.5)], 1)
    return torch.as_tensor(gt.astype(np.float32), device=dev)


def _check_words_reached(g, counts):
    """The gradient rows reach the slots each tile kind was built for."""
    assert bool(g[0, :10, 256:].abs().sum() > 0)  # past the chunk boundary
    assert bool((g[1, :10][:, [31, 32, 255, 256]].abs().sum(0) > 0).all())
    assert bool(g[2, :10, 37].abs().sum() > 0)
    assert int(counts[3]) == 0 and not g[3].any()


@pytest.mark.parametrize("exact", [False, True])
def test_k1_k7_visit_words_match_plain(dev, exact):
    """K1 (fast) and K7 (exact) on the word edge cases against their plain
    versions (loss 1e-3 relative, gradients 8e-4 + 2e-3 |p| with the
    loss-edge pixels left out), and K1 / K7 rerun bit for bit."""
    cam = Camera(fx=30.0, fy=30.0, cx=16.0, cy=16.0, width=32, height=32)
    cfg = RasterConfig(tile=16, tile_capacity=WORD_CAP, chunk=WORD_K, exact_stop=exact)
    packed, counts = _word_pack(dev, ("full", "straddle", "single", "empty"), range(4), 16)
    gt4 = _word_gt(dev, 4, 256)
    pairs = {}
    tracking_blend(packed, counts, cam, cfg, pairs=pairs)
    assert pairs["applied"] < pairs["warp_visits"] < pairs["to_last"]
    for use_sur in (True, False):
        img_k, dep_k, _ = tracking_loss_grad(packed, counts, gt4, cam, cfg, 0.7, 1.0, use_sur)
        img_p, dep_p, _ = tracking_loss_grad_plain(packed, counts, gt4, cam, cfg, 0.7, 1.0,
                                                   use_sur)
        torch.testing.assert_close(img_k + dep_k, img_p + dep_p, rtol=1e-3, atol=0)
        gt_e, _ = gt_without_loss_edges(packed, counts, gt4, cam, cfg)
        _, _, g_k = tracking_loss_grad(packed, counts, gt_e, cam, cfg, 0.7, 1.0, use_sur)
        _, _, g_p = tracking_loss_grad_plain(packed, counts, gt_e, cam, cfg, 0.7, 1.0, use_sur)
        torch.testing.assert_close(g_k, g_p, atol=8e-4, rtol=2e-3)
        _check_words_reached(g_k, counts)
        assert torch.equal(tracking_loss_grad(packed, counts, gt_e, cam, cfg, 0.7, 1.0,
                                              use_sur)[2], g_k)


def test_k8_visit_words_match_plain(dev):
    """K8 on the word edge cases, each pair of 16x8 tiles a block: a pair
    with one empty tile (full + empty) and one of two sparse tiles."""
    cam = Camera(fx=30.0, fy=30.0, cx=16.0, cy=8.0, width=32, height=16)
    cfg = RasterConfig(tile=16, tile_h=8, tile_capacity=WORD_CAP, chunk=WORD_K,
                       exact_stop=False, paired=True)
    perm = torch.arange(4, dtype=torch.int32, device=dev)
    packed, counts = _word_pack(dev, ("full", "straddle", "single", "empty"), range(4), 8)
    # Pair-major rows: (full, empty) and (straddle, single).
    order = torch.tensor([0, 3, 1, 2], device=dev)
    packed, counts, perm = packed[order].contiguous(), counts[order].contiguous(), perm[order]
    rows = _word_gt(dev, 4, 128)
    for use_sur in (True, False):
        gt = pair_gt_rows(rows)
        img_k, dep_k, _ = tracking_loss_grad_paired(packed, counts, gt, cam, cfg, 0.7, 1.0,
                                                    use_sur, tile_ids=perm)
        img_p, dep_p, _ = tracking_loss_grad_paired_plain(packed, counts, gt, cam, cfg, 0.7,
                                                          1.0, use_sur, tile_ids=perm)
        torch.testing.assert_close(img_k + dep_k, img_p + dep_p, rtol=1e-3, atol=0)
        gt_e, _ = gt_without_loss_edges(packed, counts, rows, cam, cfg, tile_ids=perm)
        gt_e = pair_gt_rows(gt_e)
        _, _, g_k = tracking_loss_grad_paired(packed, counts, gt_e, cam, cfg, 0.7, 1.0,
                                              use_sur, tile_ids=perm)
        _, _, g_p = tracking_loss_grad_paired_plain(packed, counts, gt_e, cam, cfg, 0.7, 1.0,
                                                    use_sur, tile_ids=perm)
        torch.testing.assert_close(g_k, g_p, atol=8e-4, rtol=2e-3)
        _check_words_reached(g_k[torch.tensor([0, 2, 3, 1], device=dev)], counts[[0, 2, 3, 1]])


@pytest.mark.parametrize("exact", [False, True])
def test_k4_k5_visit_words_match_plain(dev, exact):
    """K4's visit words equal its plain version's exactly; K5 on the word
    edge cases against its plain version under a seeded random cotangent
    (gate-edge pixels left out), its dead budget chunks written as zeros
    (the output is not zero-filled first), and two launches bit for bit."""
    cam = Camera(fx=30.0, fy=30.0, cx=16.0, cy=16.0, width=32, height=32)
    cfg = RasterConfig(tile=16, tile_capacity=WORD_CAP, chunk=WORD_K, exact_stop=exact)
    tiled, counts = _word_pack(dev, ("full", "straddle", "single", "empty"), range(4), 16)
    k = torch.arange(WORD_CAP, device=dev)
    idx = torch.arange(4, device=dev)[:, None] * WORD_CAP + k[None, :]
    bins = TileBins(torch.where(k[None, :] < counts[:, None].long(), idx, -1).to(torch.int32),
                    counts, torch.zeros((), dtype=torch.int32, device=dev))
    cbins = chunk_layout(bins, 4, WORD_K, 8)
    n_live = int(cbins.n_chunks)
    assert n_live == 5
    cols = torch.cat([tiled.transpose(1, 2).reshape(-1, 16), tiled.new_zeros((1, 16))])
    flat = torch.where(cbins.indices < 0, 4 * WORD_CAP, cbins.indices).long()
    packed = cols[flat].reshape(8, WORD_K, 16).transpose(1, 2).contiguous()
    out, chunk_t, last, visit = blend_flat_forward(packed, cbins, cam, cfg)
    out_p, chunk_t_p, last_p, visit_p = blend_flat_forward_plain(packed, cbins, cam, cfg)
    torch.testing.assert_close(out, out_p, atol=2e-3, rtol=0)
    assert torch.equal(visit, visit_p) and bool(visit[:n_live].any())
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    g[:, 5] = g[:, 7] = 0.0
    g, _ = cotangent_without_gate_edges(packed, cbins, g, cam, cfg)
    torch.empty((8, 16, WORD_K), device=dev).fill_(float("nan"))  # the block K5 gets next
    d_k = blend_flat_backward(packed, cbins, out, chunk_t, last, visit, g, cam, cfg)
    d_p = blend_flat_backward_plain(packed, cbins, g, cam, cfg)
    torch.testing.assert_close(d_k, d_p, atol=8e-4, rtol=2e-3)
    assert not d_k[n_live:].any() and not d_k[:, 10:].any()
    assert bool(d_k[4, :10, 37].abs().sum() > 0)  # the single lane's slot
    assert torch.equal(blend_flat_backward(packed, cbins, out, chunk_t, last, visit, g, cam,
                                           cfg), d_k)


@pytest.mark.parametrize("exact", [False, True])
def test_k3_k6_visit_words_match_plain(dev, exact):
    """K3 and K6 on the word edge cases, with opaque splats past the counts
    of the straddle and single tiles (the count bounds the blend): K3's rows
    within 2e-3 of its plain version, its last applied slots and visit words
    exactly; K6 within 8e-4 + 2e-3 |p| of its plain version under a seeded
    random cotangent (gate-edge pixels left out). Each output lands on a
    block poisoned just before the launch (NaN, or a value the kernel never
    writes), its address checked: nothing is zero-filled first, and K6's
    chunks no pixel reached, slots past the counts and rows 10-15 are
    exactly 0; two launches of
    each bit for bit. Then both on the pack padded with dead slots to
    capacity 2048: K3's rows, last slots and first chunks' words those of
    capacity 512, the new chunks' words 0; K6's gradients those of capacity
    512 in its slots and 0 past them."""
    cam = Camera(fx=30.0, fy=30.0, cx=16.0, cy=16.0, width=32, height=32)
    cfg = RasterConfig(tile=16, tile_capacity=WORD_CAP, chunk=WORD_K, exact_stop=exact)
    packed, counts = _word_pack(dev, ("full", "straddle", "single", "empty"), range(4), 16)
    for t, s in ((1, 400), (2, 130), (3, 5)):  # wide opaque splats past the count
        packed[t, 0:6, s] = torch.tensor([16.0 * (t % 2) + 7.5, 16.0 * (t // 2) + 7.5, 0.01, 0.0,
                                          0.01, 0.9])
        packed[t, 6:11, s] = 1.0
    k = torch.arange(WORD_CAP, device=dev)
    past = k[None, :] >= counts[:, None].long()
    n_chunks = WORD_CAP // WORD_K

    def forward(pk):
        # Poison one block for each output, in the wrapper's order (out,
        # chunk_t, last, visit), with values K3 never writes, and free them
        # in reverse: each output must land on its poisoned block, so every
        # element checked below is one that K3 wrote.
        n_c = pk.shape[2] // WORD_K
        poison = [torch.full((4, 8, 256), float("nan"), device=dev),
                  torch.full((4, n_c + 1, 256), float("nan"), device=dev),
                  torch.full((4, 256), -2, dtype=torch.int32, device=dev),
                  torch.full((4, n_c, 8, WORD_K // 32), -1, dtype=torch.int32, device=dev)]
        ptrs = [x.data_ptr() for x in poison]
        while poison:
            poison.pop()
        res = blend_forward(pk, counts, cam, cfg)
        assert [x.data_ptr() for x in res] == ptrs
        return res

    n0 = _build.launches["blend_forward"]
    out, chunk_t, last, visit = forward(packed)
    assert _build.launches["blend_forward"] == n0 + 1
    out_p, chunk_t_p, last_p, visit_p = blend_forward_plain(packed, counts, cam, cfg)
    torch.testing.assert_close(out, out_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(chunk_t, chunk_t_p, atol=2e-3, rtol=0)
    assert torch.equal(last, last_p) and torch.equal(visit, visit_p)
    assert bool(visit[0, 1].any()) and not visit[3].any()
    assert all(torch.equal(a, b) for a, b in zip(forward(packed), (out, chunk_t, last, visit)))

    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(dev)
    g[:, 5] = g[:, 7] = 0.0
    g, _ = tile_cotangent_without_gate_edges(packed, g, cam, cfg)

    def backward(pk, fwd):
        poison = torch.empty((4, 16, pk.shape[2]), device=dev).fill_(float("nan"))
        ptr = poison.data_ptr()
        del poison  # K6's block next
        res = blend_backward(pk, counts, *fwd[1:], g, cam, cfg)
        assert res.data_ptr() == ptr
        return res

    n0 = _build.launches["blend_backward"]
    d_k = backward(packed, (out, chunk_t, last, visit))
    assert _build.launches["blend_backward"] == n0 + 1
    d_p = blend_backward_plain(packed, counts, g, cam, cfg)
    torch.testing.assert_close(d_k, d_p, atol=8e-4, rtol=2e-3)
    assert not d_k[:, 10:].any() and not d_k.transpose(1, 2)[past].any()
    assert not d_k[2, :, WORD_K:].any() and not d_k[3].any()  # chunks no pixel reached
    _check_words_reached(d_k, counts)
    assert torch.equal(backward(packed, (out, chunk_t, last, visit)), d_k)

    cap = 2048
    padded = torch.nn.functional.pad(packed, (0, cap - WORD_CAP)).contiguous()
    fwd_r = forward(padded)
    assert torch.equal(fwd_r[0], out) and torch.equal(fwd_r[2], last)
    assert torch.equal(fwd_r[1][:, :n_chunks], chunk_t[:, :n_chunks])
    assert torch.equal(fwd_r[1][:, -1], chunk_t[:, -1])
    assert torch.equal(fwd_r[3][:, :n_chunks], visit) and not fwd_r[3][:, n_chunks:].any()
    d_r = backward(padded, fwd_r)
    assert torch.equal(d_r[..., :WORD_CAP], d_k) and not d_r[..., WORD_CAP:].any()


@pytest.mark.parametrize("kind", ["K1", "K7", "K8", "K9"])
def test_tracking_kernels_at_capacity_2048(dev, kind):
    """The tracking kernels' shared memory does not grow with the capacity
    (each backward window is staged from global memory): the word pack
    padded with dead slots to capacity 2048 launches and gives the loss and
    the gradients of capacity 512 bit for bit, zeros in the padding, and
    the plain version's loss within 1e-3 relative; two launches bit for
    bit."""
    paired = kind == "K8"
    ts_y = 8 if paired else 16
    cam = Camera(fx=30.0, fy=30.0, cx=16.0, cy=ts_y / 2, width=32, height=2 * ts_y)
    cfg = RasterConfig(tile=16, tile_h=ts_y, tile_capacity=WORD_CAP, chunk=WORD_K,
                       exact_stop=kind == "K7", paired=paired)
    packed, counts = _word_pack(dev, ("full", "straddle", "single", "empty"), range(4), ts_y)
    rows = _word_gt(dev, 4, 16 * ts_y)
    if paired:
        order = torch.tensor([0, 3, 1, 2], device=dev)
        packed, counts = packed[order].contiguous(), counts[order].contiguous()
        perm = order.to(torch.int32)
        gt = pair_gt_rows(rows)

        def run(pk):
            return tracking_loss_grad_paired(pk, counts, gt, cam, cfg, 0.7, 1.0, False,
                                             tile_ids=perm)

        plain = tracking_loss_grad_paired_plain(packed, counts, gt, cam, cfg, 0.7, 1.0, False,
                                                tile_ids=perm)
    elif kind == "K9":
        def run(pk):
            return tracking_loss_grad_ablate(pk, rows, cam, cfg, 0.7, 1.0, False)

        plain = tracking_loss_grad_ablate_plain(packed, rows, cam, cfg, 0.7, 1.0, False)
    else:
        def run(pk):
            return tracking_loss_grad(pk, counts, rows, cam, cfg, 0.7, 1.0, False)

        plain = tracking_loss_grad_plain(packed, counts, rows, cam, cfg, 0.7, 1.0, False)
    img, dep, g = run(packed)
    cap = 2048
    img_r, dep_r, g_r = run(torch.nn.functional.pad(packed, (0, cap - WORD_CAP)).contiguous())
    assert torch.equal(img_r, img) and torch.equal(dep_r, dep)
    assert torch.equal(g_r[..., :WORD_CAP], g) and not g_r[..., WORD_CAP:].any()
    assert bool(g[..., :WORD_CAP].abs().sum() > 0)
    torch.testing.assert_close(img_r + dep_r, plain[0] + plain[1], rtol=1e-3, atol=0)
    assert torch.equal(run(torch.nn.functional.pad(packed, (0, cap - WORD_CAP)).contiguous())[2],
                       g_r)


def test_knn3_window_on_the_card_matches_the_cpu(dev):
    """The Morton-window 3-NN (``ops.knn``) on the card against the same
    function on the CPU: equal Morton codes, mean squared distances within
    1e-6 relative, on a depth frame's back-projected candidates."""
    from gsorb_slam_tpu_torch.ops import knn

    rng = np.random.default_rng(0)
    h, w = 96, 128
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.0 + 0.3 * np.sin(u / 20.0) + rng.normal(0, 0.002, (h, w)).astype(np.float32)
    pts = np.stack([(u - 64) / 120 * z, (v - 48) / 120 * z, z], -1).reshape(-1, 3)
    pts = np.concatenate([pts, pts[:500]]).astype(np.float32)  # duplicate codes
    valid = rng.uniform(size=len(pts)) > 0.05
    cpu = knn.knn3_mean_sq_dist(torch.as_tensor(pts), torch.as_tensor(valid))
    p, m = torch.as_tensor(pts, device=dev), torch.as_tensor(valid, device=dev)
    assert torch.equal(knn.morton_codes(p, m).cpu(),
                       knn.morton_codes(torch.as_tensor(pts), torch.as_tensor(valid)))
    torch.testing.assert_close(knn.knn3_mean_sq_dist(p, m).cpu(), cpu, rtol=1e-6, atol=0)


def _bits(t):
    return t.view(torch.int32)


def _maps(dev):
    """The adjoint's edge map and a random map seen from a pose near the
    identity."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    T = pose_to_matrix(f32([1.0, 0.01, -0.01, 0.005]), f32([0.02, -0.01, 0.0]))
    return [adjoint_edge_map(8 * 2048, 0, CAM, device=dev), (*_scene(dev, 50000), T)]


@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
def test_k10f_equals_the_plain_composite_bit_for_bit(dev, scale_modifier):
    """K10f's table and radii equal ``attr_cols(preprocess(...))`` and its
    radii bit for bit, in one launch; a second launch gives the same bits."""
    for m in _maps(dev):
        n0 = _build.launches["map_attr_fwd"]
        cols, radius = map_attr_table_forward(*m, CAM, scale_modifier)
        assert _build.launches["map_attr_fwd"] == n0 + 1
        want_cols, want_radius = map_attr_table_plain(*m, CAM, scale_modifier)
        assert torch.equal(_bits(cols), _bits(want_cols))
        assert torch.equal(_bits(radius), _bits(want_radius))
        cols2, radius2 = map_attr_table_forward(*m, CAM, scale_modifier)
        assert torch.equal(_bits(cols2), _bits(cols)) and torch.equal(_bits(radius2),
                                                                      _bits(radius))


@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
def test_k10b_matches_the_plain_adjoint_and_autograd(dev, scale_modifier):
    """K10b's gradients against the plain adjoint and against autograd
    through the plain composite, each group within 1e-5 of its largest |g|
    per row kind; through ``map_attr_table`` autograd reaches K10b itself
    (one launch); two launches bitwise equal."""
    m = adjoint_edge_map(8 * 2048, 1, CAM, device=dev)
    g = torch.randn((m[0].shape[0] + 1, 16), generator=torch.Generator().manual_seed(2))
    g = g.to(dev)
    g[:, 10:] = 0.0
    got = map_attr_table_backward(g, *m, CAM, scale_modifier)
    plain = map_attr_table_backward_plain(g, *m, CAM, scale_modifier)
    params = [p.clone().requires_grad_(True) for p in m[:5]]
    cols, _ = map_attr_table_plain(*params, *m[5:], CAM, scale_modifier)
    auto = torch.autograd.grad((cols * g).sum(), params)
    kind = torch.arange(m[0].shape[0], device=dev) % len(MAP_EDGE_KINDS)
    for want in (plain, auto):
        for w, h in zip(want, got):
            for k in range(len(MAP_EDGE_KINDS)):
                rows = kind == k
                err = float((h[rows] - w[rows]).abs().max())
                assert err <= 1e-5 * float(w[rows].abs().max()), (MAP_EDGE_KINDS[k], err)

    n0 = _build.launches["map_attr_bwd"]
    cols_k, _ = map_attr_table(*params, *m[5:], CAM, scale_modifier)
    via = torch.autograd.grad((cols_k * g).sum(), params)
    assert _build.launches["map_attr_bwd"] == n0 + 1
    again = map_attr_table_backward(g, *m, CAM, scale_modifier)
    for a, b, c in zip(got, via, again):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c))


# The three cells' frame sizes (1241 = 77 x 16 + 9: a partial tile).
SSIM_SIZES = [(480, 640), (680, 1200), (376, 1241)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H,W", SSIM_SIZES)
def test_k11_matches_the_plain_composite(dev, H, W, masked):
    """K11f's value within 1e-5 of the plain composite, K11b's gradient
    within 2e-5 of autograd's through it (of the largest |g|), one launch
    each; no gradient wanted: K11f alone."""
    _build.library()  # pins full f32 for the composite's convolutions
    pred, target, mask = ssim_image_pair(H, W, H + W + masked, dev)
    m = mask if masked else None
    x = pred.clone().requires_grad_(True)
    want = losses.ssim_plain(x, target, m)
    (want_g,) = torch.autograd.grad(want, x)
    n0 = dict(_build.launches)
    got = losses.ssim(x, target, m)
    (got_g,) = torch.autograd.grad(got, x)
    assert (_build.launches["ssim_fwd"] - n0["ssim_fwd"],
            _build.launches["ssim_bwd"] - n0["ssim_bwd"]) == (1, 1)
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    assert bool(torch.isfinite(got_g).all())
    assert float((got_g - want_g).abs().max()) <= 2e-5 * float(want_g.abs().max())
    with torch.no_grad():
        alone = losses.ssim(pred, target, m)
    assert _build.launches["ssim_fwd"] - n0["ssim_fwd"] == 2
    assert _build.launches["ssim_bwd"] - n0["ssim_bwd"] == 1
    assert torch.equal(_bits(alone), _bits(got.detach()))


@pytest.mark.parametrize("masked", [False, True])
def test_k11_reruns_bit_for_bit_and_replays_as_a_graph(dev, masked):
    """Two runs of K11f / K11b give the same bits; a CUDA graph of the value
    and its gradient, replayed on new inputs, equals the eager call."""
    H, W = SSIM_SIZES[2]
    pred, target, mask = ssim_image_pair(H, W, 7, dev)
    m = mask if masked else None
    x = pred.clone().requires_grad_(True)

    def body():
        v = losses.ssim(x, target, m)
        return v.detach(), torch.autograd.grad(v, x)[0]

    first, second = body(), body()
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    for seed in (8, 9):
        new_pred, _, _ = ssim_image_pair(H, W, seed, dev)
        with torch.no_grad():
            x.copy_(new_pred)
        graph.replay()
        eager = body()
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(static, eager))
