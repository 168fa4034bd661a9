"""The exact-stop and paired-rect tracking paths (K7, K8) of the port against
the JAX package on the CPU, Pallas in interpret mode.

Tolerances (those of ``tests/test_paired.py`` and the fast K1 tests):
- the plain versions of K7 and K8 against ``tracking_loss_grad`` (exact)
  and ``tracking_loss_grad_paired``: loss rtol 2e-3, per-instance gradients
  atol 8e-4 / rtol 2e-3 (the Pallas kernels stop per chunk, the port per
  pixel, and the TPU kernels sum in another order);
- the pose gradient through the projection and each kernel: 1e-3 of its
  largest component;
- ``track_frame`` with ``paired=True`` (its rect tracking view) and with
  ``exact_stop=True`` over 10 iterations with one rebin: pose 1e-4 abs,
  loss 2e-3 rel (as the fast path's ``tests/test_torch_tracking.py``);
- the pairing permutations and the paired gt layout: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import TrackingConfig as JTrackingConfig
from gsorb_slam_tpu.core.transforms import pose_to_matrix as jpose_to_matrix
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster import render as jrender
from gsorb_slam_tpu.raster import render_tiled as jrender_tiled
from gsorb_slam_tpu.raster.instances import pack_raw_instances as jpack_raw
from gsorb_slam_tpu.raster.pallas_raster import _pack_instances as jpack
from gsorb_slam_tpu.raster.pallas_raster import tile_gt_images as jtile_gt
from gsorb_slam_tpu.raster.pallas_raster import tracking_loss_grad as jtracking_loss_grad
from gsorb_slam_tpu.raster.paired import count_sorted_pair_permutation as jcount_sorted
from gsorb_slam_tpu.raster.paired import pack_gt_pairs as jpack_gt_pairs
from gsorb_slam_tpu.raster.paired import pair_permutation as jpair_permutation
from gsorb_slam_tpu.raster.paired import tracking_loss_grad_paired as jtracking_loss_grad_paired
from gsorb_slam_tpu.raster.preprocess_pallas import preprocess_instances_pallas, rt_from_matrix
from gsorb_slam_tpu.slam.tracking import FeatureMatches as JFeatureMatches
from gsorb_slam_tpu.slam.tracking import track_frame as jtrack_frame
from gsorb_slam_tpu.splat.gaussians import empty_map as jempty_map
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.interop import gaussian_map_from_numpy
from gsorb_slam_tpu_torch.raster.binning import tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    tile_gt_images,
    tracking_loss_grad,
    tracking_loss_grad_plain,
)
from gsorb_slam_tpu_torch.raster.instances import screen_rows
from gsorb_slam_tpu_torch.raster.paired import (
    count_sorted_pair_permutation,
    pack_gt_pairs,
    pair_permutation,
    tracking_loss_grad_paired,
    tracking_loss_grad_paired_plain,
    unpack_gt_pairs,
)
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches, track_frame, tracking_raster_config

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64)
RECT_KW = dict(CFG_KW, tile_h=8, exact_stop=False)
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
IM_W, DEPTH_W = 0.7, 1.0


def _t(x):
    return torch.as_tensor(np.array(x))


def _prep(scene, T=None):
    return jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4) if T is None else T,
                       JCamera(**CAM_KW))


def _gt(rng):
    """A gt rendered from another scene, so signs and masks are non-trivial."""
    jc = JCamera(**CAM_KW)
    jcfg = JRasterConfig(**CFG_KW, exact_stop=False)
    prep = _prep(random_cloud_scene(rng, n=300, capacity=384))
    ref = jrender_tiled(prep, jbin(prep, jc, jcfg), jc, jcfg)
    return ref.color, jnp.where(ref.alpha > 0.3, ref.median_depth, 0.0)


def _check_close(img, dep, grads, j_img, j_dep, j_grads):
    np.testing.assert_allclose(float(img + dep), float(j_img + j_dep), rtol=2e-3)
    np.testing.assert_allclose(grads[:, :10].numpy(), np.asarray(j_grads)[:, :10],
                               atol=8e-4, rtol=2e-3)
    assert not grads[:, 10:].any()


def test_pair_permutations_match_jax():
    np.testing.assert_array_equal(pair_permutation(6, 4), jpair_permutation(6, 4))
    with pytest.raises(ValueError):
        pair_permutation(5, 4)
    # Ties (empty tiles and equal counts) keep the lower tile id first.
    counts = np.array([3, 0, 7, 3, 0, 9, 7, 1, 0, 3, 12, 0], np.int32)
    got = count_sorted_pair_permutation(torch.as_tensor(counts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcount_sorted(jnp.asarray(counts))))
    assert got.dtype == torch.int32
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 5, 48).astype(np.int32)
    np.testing.assert_array_equal(
        count_sorted_pair_permutation(torch.as_tensor(counts)).numpy(),
        np.asarray(jcount_sorted(jnp.asarray(counts))))


def test_pack_gt_pairs_matches_jax(rng):
    cam, jc = Camera(**CAM_KW), JCamera(**CAM_KW)
    color = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, size=(48, 64)).astype(np.float32)
    tcfg, jcfg = RasterConfig(**RECT_KW), JRasterConfig(**RECT_KW)
    perm = rng.permutation(24).astype(np.int32)
    for p in (None, perm):
        j = jpack_gt_pairs(jnp.asarray(color), jnp.asarray(depth), jc, jcfg,
                           None if p is None else jnp.asarray(p))
        t = pack_gt_pairs(_t(color), _t(depth), cam, tcfg, None if p is None else _t(p))
        assert t.shape == (12, 4, 256)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:, :4])
    # Un-pairing gives the rect tiles in the pairing's order.
    rows = tile_gt_images(_t(color), _t(depth), cam, tcfg)[torch.as_tensor(perm).long()]
    assert torch.equal(unpack_gt_pairs(t), rows)


@pytest.fixture
def paired_inputs(rng):
    """Screen instances of a scene binned on 16x8 rect tiles, in the
    count-sorted pair-major order, and a paired gt."""
    jc = JCamera(**CAM_KW)
    jcfg = JRasterConfig(**RECT_KW)
    prep = _prep(random_cloud_scene(rng, n=300, capacity=384))
    bins = jbin(prep, jc, jcfg)
    perm = jcount_sorted(bins.counts)
    packed = jpack(prep, bins)[perm]
    gt_color, gt_depth = _gt(rng)
    gt_pairs = jpack_gt_pairs(gt_color, gt_depth, jc, jcfg, perm)
    return jcfg, packed, bins.counts[perm], perm, gt_pairs


@pytest.mark.parametrize("use_sur", [True, False])
def test_k8_plain_matches_pallas(paired_inputs, use_sur):
    jcfg, packed, counts, perm, gt_pairs = paired_inputs
    j_img, j_dep, j_grads = jtracking_loss_grad_paired(
        packed, counts, gt_pairs, JCamera(**CAM_KW), jcfg, IM_W, DEPTH_W, use_sur,
        interpret=True, tile_ids=perm)
    cam, tcfg = Camera(**CAM_KW), RasterConfig(**RECT_KW)
    args = (_t(packed), _t(counts), _t(np.asarray(gt_pairs)[:, :4]), cam, tcfg, IM_W, DEPTH_W,
            use_sur)
    img, dep, grads = tracking_loss_grad_paired_plain(*args, tile_ids=_t(perm))
    _check_close(img, dep, grads, j_img, j_dep, j_grads)
    # The wrapper takes the plain version for CPU tensors.
    w_img, w_dep, w_grads = tracking_loss_grad_paired(*args, tile_ids=_t(perm))
    assert torch.equal(w_grads, grads) and float(w_img + w_dep) == float(img + dep)
    # K8 is K1 over the rect tiles with the pairing as tile ids.
    k1 = tracking_loss_grad_plain(args[0], args[1], unpack_gt_pairs(args[2]), *args[3:],
                                  tile_ids=_t(perm))
    assert torch.equal(k1[2], grads)
    with pytest.raises(ValueError):
        tracking_loss_grad_paired_plain(*args[:4], dataclasses.replace(tcfg, exact_stop=True),
                                        *args[5:], tile_ids=_t(perm))


@pytest.mark.parametrize("use_sur", [True, False])
def test_k7_plain_matches_pallas_exact(rng, use_sur):
    jc = JCamera(**CAM_KW)
    jcfg = JRasterConfig(**CFG_KW, exact_stop=True)
    scene = random_cloud_scene(rng, n=300, capacity=384)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 4.0)  # pixels saturate
    prep = _prep(scene)
    bins = jbin(prep, jc, jcfg)
    packed = jpack(prep, bins)
    gt4 = jtile_gt(*_gt(rng), jc, jcfg)
    j_img, j_dep, j_grads = jtracking_loss_grad(packed, bins.counts, gt4, jc, jcfg, IM_W,
                                                DEPTH_W, use_sur, interpret=True)
    cam, tcfg = Camera(**CAM_KW), RasterConfig(**CFG_KW, exact_stop=True)
    args = (_t(packed), _t(bins.counts), _t(np.asarray(gt4)[:, :4]), cam, tcfg, IM_W, DEPTH_W,
            use_sur)
    img, dep, grads = tracking_loss_grad_plain(*args)
    _check_close(img, dep, grads, j_img, j_dep, j_grads)
    w_img, w_dep, w_grads = tracking_loss_grad(*args)
    assert torch.equal(w_grads, grads) and float(w_img + w_dep) == float(img + dep)
    # The fast rule gives another result on this scene.
    fast = tracking_loss_grad_plain(*args[:4], dataclasses.replace(tcfg, exact_stop=False),
                                    *args[5:])
    assert not torch.equal(fast[2], grads)


@pytest.mark.parametrize("mode", ["exact", "paired"])
def test_pose_gradient_matches_jax(rng, mode):
    """The pose gradient of one tracking iteration: the projection and K7 /
    K8's plain version with autograd against JAX's projection VJP and the
    Pallas kernel."""
    jc, cam = JCamera(**CAM_KW), Camera(**CAM_KW)
    kw = RECT_KW if mode == "paired" else dict(CFG_KW, exact_stop=True)
    jcfg, tcfg = JRasterConfig(**kw), RasterConfig(**kw)
    scene = random_cloud_scene(rng, n=250, capacity=256)
    bins = jbin(_prep(scene), jc, jcfg)
    perm = jcount_sorted(bins.counts) if mode == "paired" else jnp.arange(12, dtype=jnp.int32)
    raw = jpack_raw(*(scene[k] for k in KEYS), bins)[perm]
    counts = bins.counts[perm]
    gt_color, gt_depth = _gt(rng)
    q0, t0 = jnp.array([1.0, 0.004, -0.003, 0.005]), jnp.array([0.01, -0.008, 0.012])

    screen_j, vjp = jax.vjp(lambda q, t: preprocess_instances_pallas(
        raw, rt_from_matrix(jpose_to_matrix(q, t)), jc, 1.0, 8, True), q0, t0)
    if mode == "paired":
        gt = jpack_gt_pairs(gt_color, gt_depth, jc, jcfg, perm)
        _, _, d = jtracking_loss_grad_paired(screen_j, counts, gt, jc, jcfg, IM_W, DEPTH_W,
                                             True, interpret=True, tile_ids=perm)
    else:
        gt = jtile_gt(gt_color, gt_depth, jc, jcfg)
        _, _, d = jtracking_loss_grad(screen_j, counts, gt, jc, jcfg, IM_W, DEPTH_W, True,
                                      interpret=True)
    jg = vjp(d)

    from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
    from gsorb_slam_tpu_torch.raster.instances import rt_from_matrix as trt

    q, t = _t(q0).requires_grad_(True), _t(t0).requires_grad_(True)
    screen = screen_rows(_t(raw), trt(pose_to_matrix(q, t)), cam, 1.0)
    if mode == "paired":
        gt = pack_gt_pairs(_t(gt_color), _t(gt_depth), cam, tcfg, _t(perm))
        _, _, d = tracking_loss_grad_paired(screen.detach(), _t(counts), gt, cam, tcfg, IM_W,
                                            DEPTH_W, True, tile_ids=_t(perm))
    else:
        gt = tile_gt_images(_t(gt_color), _t(gt_depth), cam, tcfg)
        _, _, d = tracking_loss_grad(screen.detach(), _t(counts), gt, cam, tcfg, IM_W,
                                     DEPTH_W, True)
    torch.autograd.backward(screen, d)
    for got, want in ((q.grad, jg[0]), (t.grad, jg[1])):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["paired", "exact"])
def test_track_frame_matches_jax(rng, mode):
    """``track_frame`` on the tracking view of a ``paired=True`` config (16x8
    rect tiles, count-sorted pairs rebuilt at the rebin) and with
    ``exact_stop=True``, against the JAX package's Pallas path."""
    iters, rebin = 10, (5,)
    scene = random_cloud_scene(rng, n=400, capacity=512, spread=1.6)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 6.0)
    jgm = jempty_map(512)
    jgm = jgm.__class__(**{**jgm.__dict__, **scene, "count": jnp.asarray(400, jnp.int32)})
    jc, cam = JCamera(**CAM_KW), Camera(**CAM_KW)
    base = dict(CFG_KW, dilate_px=4.0, exact_stop=mode == "exact", paired=mode == "paired")
    out = jrender(*(scene[k] for k in KEYS), jnp.eye(4), jc, JRasterConfig(**CFG_KW))
    gt_color = out.color
    gt_depth = jnp.where(out.alpha > 0.5, out.median_depth, 0.0)
    T_init = jpose_to_matrix(jnp.array([1.0, 0.004, -0.003, 0.005]),
                             jnp.array([0.015, -0.01, 0.012]))

    # The port's tracking view of the config: rect tiles when paired (the
    # JAX System's view, slam/system.py:354-359).
    rcfg_t = tracking_raster_config(RasterConfig(**base))
    want_grid = (6, 4) if mode == "paired" else (3, 4)
    assert tile_grid_shape(cam, rcfg_t) == want_grid
    jcfg_t = JRasterConfig(**base, tile_h=rcfg_t.tile_h, backend="pallas")
    jres = jax.jit(lambda: jtrack_frame(
        jgm, T_init, gt_color, gt_depth, JFeatureMatches.empty(), jc,
        JTrackingConfig(num_iters=iters, early_stop_delta=0.0), jcfg_t, rebin_iters=rebin,
    ))()

    d = {f: np.asarray(getattr(jgm, f)) for f in (*KEYS, "count", "max_z", "scene_radius")}
    tres = track_frame(
        gaussian_map_from_numpy(d, device="cpu"), _t(T_init), _t(gt_color), _t(gt_depth),
        FeatureMatches.empty(device="cpu"), cam,
        TrackingConfig(num_iters=iters, early_stop_delta=0.0), rcfg_t, rebin_iters=rebin,
    )
    assert int(tres.n_iters) == int(jres.n_iters) == iters
    T_j = np.asarray(jres.T_cw)
    np.testing.assert_allclose(tres.T_cw.numpy(), T_j, atol=1e-4)
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=2e-3)
    assert np.abs(T_j - np.eye(4)).max() < np.abs(np.asarray(T_init) - np.eye(4)).max()


def test_paired_exact_stop_raises():
    with pytest.raises(ValueError):
        tracking_raster_config(RasterConfig(**CFG_KW, paired=True, exact_stop=True))
