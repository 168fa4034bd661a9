"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

- K1 (fused tracking, fast stop): loss rtol 2e-3, per-instance gradients
  atol 8e-4 / rtol 2e-3 (the fast-path tolerances of
  ``tests/test_pallas.py``). The Pallas kernel stops at chunk granularity,
  the port per pixel; past-stop contributions are bounded by the 1e-4 exit
  transmittance.
- K2 (instance projection): screen rows 1e-5; pose cotangent rtol 1e-4.
- K3 (forward blend), both stop rules: color, alpha, final T 2e-3; depth
  and median depth 5e-3 (the compiled-vs-XLA gate of
  ``scripts/tpu_smoke.py``).

On CPU tensors the kernel wrappers take these plain versions; that dispatch
is checked here too, and so are the plain blend's pair counts (the work
``chip_smoke.py`` charges in the kernels' bounds) against the kernels'
per-pixel loop. The CUDA kernels themselves are held against the same
plain versions on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.transforms import pose_to_matrix as jpose_to_matrix
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster import render_tiled as jrender_tiled
from gsorb_slam_tpu.raster.instances import pack_raw_instances as jpack_raw
from gsorb_slam_tpu.raster.pallas_raster import _pack_instances as jpack
from gsorb_slam_tpu.raster.pallas_raster import render_pallas
from gsorb_slam_tpu.raster.pallas_raster import tile_gt_images as jtile_gt
from gsorb_slam_tpu.raster.pallas_raster import tracking_loss_grad as jtracking_loss_grad
from gsorb_slam_tpu.raster.preprocess_pallas import preprocess_instances_pallas, rt_from_matrix
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_and_untile,
    blend_forward,
    blend_forward_plain,
    footprint_keep,
    gt_without_loss_edges,
    tile_gt_images,
    tracking_blend,
    tracking_loss_grad,
    tracking_loss_grad_plain,
)
from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
    preprocess_bwd_plain,
    preprocess_instances_kernel,
)
from gsorb_slam_tpu_torch.raster.instances import screen_rows
from gsorb_slam_tpu_torch.raster.types import RasterConfig

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64)
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")


def _t(x):
    return torch.as_tensor(np.array(x))


def _prep(scene):
    return jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), JCamera(**CAM_KW))


@pytest.fixture
def tracking_inputs(rng):
    """Packed screen instances of one scene and a gt rendered from another,
    so signs and masks are non-trivial (as tests/test_pallas.py:134)."""
    jcfg = JRasterConfig(**CFG_KW, exact_stop=False)
    jc = JCamera(**CAM_KW)
    prep = _prep(random_cloud_scene(rng, n=300, capacity=384))
    bins = jbin(prep, jc, jcfg)
    packed = jpack(prep, bins)
    prep2 = _prep(random_cloud_scene(rng, n=300, capacity=384))
    ref2 = jrender_tiled(prep2, jbin(prep2, jc, jcfg), jc, jcfg)
    gt_color = ref2.color
    gt_depth = jnp.where(ref2.alpha > 0.3, ref2.median_depth, 0.0)
    return jcfg, packed, bins.counts, gt_color, gt_depth


@pytest.mark.parametrize("use_sur", [True, False])
def test_k1_plain_matches_pallas_fast(tracking_inputs, use_sur):
    jcfg, packed, counts, gt_color, gt_depth = tracking_inputs
    im_w, depth_w = 0.7, 1.0
    gt4 = jtile_gt(gt_color, gt_depth, JCamera(**CAM_KW), jcfg)
    j_img, j_dep, j_grads = jtracking_loss_grad(
        packed, counts, gt4, JCamera(**CAM_KW), jcfg, im_w, depth_w, use_sur, interpret=True
    )
    tcfg = RasterConfig(**CFG_KW, exact_stop=False)
    cam = Camera(**CAM_KW)
    tgt4 = tile_gt_images(_t(gt_color), _t(gt_depth), cam, tcfg)
    np.testing.assert_array_equal(tgt4.numpy(), np.asarray(gt4)[:, :4])
    img, dep, grads = tracking_loss_grad_plain(
        _t(packed), _t(counts), tgt4, cam, tcfg, im_w, depth_w, use_sur
    )
    np.testing.assert_allclose(float(img + dep), float(j_img + j_dep), rtol=2e-3)
    np.testing.assert_allclose(grads[:, :10].numpy(), np.asarray(j_grads)[:, :10],
                               atol=8e-4, rtol=2e-3)
    assert not grads[:, 10:].any()
    # The wrapper takes the plain version for CPU tensors.
    w_img, w_dep, w_grads = tracking_loss_grad(
        _t(packed), _t(counts), tgt4, cam, tcfg, im_w, depth_w, use_sur
    )
    assert torch.equal(w_grads, grads) and float(w_img) == float(img)


def test_k2_plain_matches_pallas(rng):
    jcfg = JRasterConfig(**CFG_KW)
    jc = JCamera(**CAM_KW)
    scene = random_cloud_scene(rng, n=300, capacity=320)
    bins = jbin(_prep(scene), jc, jcfg)
    raw = jpack_raw(*(scene[k] for k in KEYS), bins)
    T = jpose_to_matrix(jnp.array([1.0, 0.01, -0.02, 0.015]), jnp.array([0.03, -0.02, 0.05]))
    rt = rt_from_matrix(T)
    sm = 1.1
    j_out, vjp = jax.vjp(lambda r: preprocess_instances_pallas(raw, r, jc, sm, 8, True), rt)
    d_screen = rng.normal(size=j_out.shape).astype(np.float32)
    (j_drt,) = vjp(jnp.asarray(d_screen))

    cam = Camera(**CAM_KW)
    t_out = screen_rows(_t(raw), _t(rt), cam, sm)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=1e-5)
    t_drt = preprocess_bwd_plain(_t(raw), _t(rt), _t(d_screen), cam, sm)
    np.testing.assert_allclose(t_drt.numpy(), np.asarray(j_drt), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(j_drt)).max()))
    # The autograd.Function wrapper takes the plain pair on CPU tensors.
    rt_t = _t(rt).requires_grad_(True)
    out = preprocess_instances_kernel(_t(raw), rt_t, cam, sm)
    out.backward(_t(d_screen))
    assert torch.equal(out.detach(), t_out)
    np.testing.assert_allclose(rt_t.grad.numpy(), t_drt.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_k3_plain_matches_pallas(rng, exact):
    jcfg = JRasterConfig(**CFG_KW, exact_stop=exact)
    jc = JCamera(**CAM_KW)
    scene = random_cloud_scene(rng, n=350, capacity=384)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 3.0)
    prep = _prep(scene)
    bins = jbin(prep, jc, jcfg)
    jo = render_pallas(prep, bins, jc, jcfg, bg=0.1, interpret=True)
    tcfg = RasterConfig(**CFG_KW, exact_stop=exact)
    cam = Camera(**CAM_KW)
    packed = _t(jpack(prep, bins))
    to = blend_and_untile(packed, _t(bins.counts), cam, tcfg, bg=0.1)
    for k, tol in (("color", 2e-3), ("alpha", 2e-3), ("final_t", 2e-3), ("depth", 5e-3),
                   ("median_depth", 5e-3)):
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                   atol=tol, err_msg=k)
    # chunk_t: incoming T per chunk (0 once done), final T last.
    out, chunk_t, _, _ = blend_forward_plain(packed, _t(bins.counts), cam, tcfg)
    assert chunk_t.shape == (12, 256 // 64 + 1, 256)
    np.testing.assert_array_equal(chunk_t[:, -1].numpy(), out[:, 6].numpy())
    assert bool((chunk_t[:, 0] == 1.0).all())
    w_out, w_ct, _, _ = blend_forward(packed, _t(bins.counts), cam, tcfg)
    assert torch.equal(w_out, out) and torch.equal(w_ct, chunk_t)


def _pair_counts_per_pixel(packed, counts, pu, pv, exact, keep=None):
    """The kernels' per-pixel loop, instance by instance, counting the
    evaluated and applied (pixel, instance) pairs, the pairs up to each
    pixel's last applied instance and the (lane, slot) pairs the backward
    walks: 32 for every slot some pixel of a warp (32 consecutive pixels)
    applied. With ``keep [T, px / 32, cap]`` (K4's footprint cull) also the
    (lane, slot) pairs a culled forward walks: 32 for every kept slot
    reached while some pixel of the warp still blends."""
    n_eval = n_apply = n_last = n_visit = n_kept = 0
    for t in range(packed.shape[0]):
        T = np.ones(pu.shape[1])
        live = np.ones(pu.shape[1], bool)
        last = np.zeros(pu.shape[1], np.int64)
        for k in range(int(counts[t])):
            mu, mv, ca, cb, cc, op = packed[t, :6, k]
            d0, d1 = mu - pu[t], mv - pv[t]
            power = -0.5 * (ca * d0 * d0 + cc * d1 * d1) - cb * d0 * d1
            alpha = np.minimum(0.99, op * np.exp(power))
            n_eval += int(live.sum())
            if keep is not None:
                n_kept += 32 * int((live.reshape(-1, 32).any(axis=1) & keep[t, :, k]).sum())
            hit = live & (power <= 0) & (alpha >= 1.0 / 255.0)
            Tn = T * (1.0 - alpha)
            if exact:
                live &= ~(hit & (Tn < 1e-4))
                hit &= live
            n_apply += int(hit.sum())
            n_visit += 32 * int(hit.reshape(-1, 32).any(axis=1).sum())
            last = np.where(hit, k + 1, last)
            T = np.where(hit, Tn, T)
            if not exact:
                live &= T >= 1e-4
        n_last += int(last.sum())
    res = dict(evaluated=n_eval, applied=n_apply, to_last=n_last, warp_visits=n_visit)
    if keep is not None:
        res["warp_kept"] = n_kept
    return res


@pytest.mark.parametrize("exact", [True, False])
def test_blend_pair_counts_match_per_pixel_loop(rng, exact):
    """The pair counts the plain blend reports (the work chip_smoke's bounds
    charge) equal those of the kernels' per-pixel loop."""
    jc = JCamera(**CAM_KW)
    scene = random_cloud_scene(rng, n=350, capacity=384)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 3.0)
    prep = _prep(scene)
    bins = jbin(prep, jc, JRasterConfig(**CFG_KW))
    packed = np.asarray(jpack(prep, bins), np.float64)
    cfg = RasterConfig(**CFG_KW, exact_stop=exact)
    pairs = {}
    blend_forward_plain(_t(packed).float(), _t(bins.counts), Camera(**CAM_KW), cfg, pairs=pairs)
    pu, pv = (np.tile(np.arange(256) % 16, (12, 1)), np.tile(np.arange(256) // 16, (12, 1)))
    pu = pu + (np.arange(12) % 4)[:, None] * 16
    pv = pv + (np.arange(12) // 4)[:, None] * 16
    keep = footprint_keep(_t(packed).float(), _t(pu).float(), _t(pv).float()).numpy()
    ref = _pair_counts_per_pixel(packed, np.asarray(bins.counts), pu, pv, exact, keep)
    assert pairs == ref
    assert ref["warp_visits"] <= ref["warp_kept"] < 32 * ref["evaluated"]
    assert ref["applied"] < ref["evaluated"] and ref["to_last"] <= ref["evaluated"]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("tile_h", [16, 8])
def test_warp_visits_match_per_pixel_loop(rng, exact, tile_h):
    """The backward's (lane, slot) pairs that ``tracking_blend`` reports for
    K1 / K7 (square tiles) and K8 (16x8 rect tiles, counted per tile half)
    equal a per-pixel loop's: 32 x the distinct applied slots of each warp.
    The word-driven walk visits far fewer pairs than the walk to each
    pixel's last applied slot."""
    jc = JCamera(**CAM_KW)
    kw = dict(CFG_KW, tile_h=tile_h)
    scene = random_cloud_scene(rng, n=350, capacity=384)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 3.0)
    prep = _prep(scene)
    bins = jbin(prep, jc, JRasterConfig(**kw))
    packed = np.asarray(jpack(prep, bins), np.float64)
    cfg = RasterConfig(**kw, exact_stop=exact)
    pairs = {}
    tracking_blend(_t(packed).float(), _t(bins.counts), Camera(**CAM_KW), cfg, pairs=pairs)
    n_tiles = packed.shape[0]
    tiles_x = 64 // 16
    loc = np.arange(16 * tile_h)
    pu = (np.arange(n_tiles) % tiles_x)[:, None] * 16 + loc % 16
    pv = (np.arange(n_tiles) // tiles_x)[:, None] * tile_h + loc // 16
    ref = _pair_counts_per_pixel(packed, np.asarray(bins.counts), pu, pv, exact)
    assert pairs["warp_visits"] == ref["warp_visits"]
    assert pairs["applied"] < pairs["warp_visits"] < pairs["to_last"]


def test_gt_without_loss_edges():
    """Pixels whose residual is 0 (the L1 kink) leave the loss mask; pixels
    far from every discontinuity stay."""
    cam, cfg = Camera(**CAM_KW), RasterConfig(**CFG_KW)
    rng = np.random.default_rng(0)
    packed = torch.zeros((12, 16, 256))
    packed[:, 0] = torch.as_tensor(rng.uniform(0, 64, (12, 256)), dtype=torch.float32)
    packed[:, 1] = torch.as_tensor(rng.uniform(0, 48, (12, 256)), dtype=torch.float32)
    packed[:, 2] = packed[:, 4] = 0.05
    packed[:, 5] = 0.9
    packed[:, 6:10] = torch.as_tensor(rng.uniform(0.2, 1, (12, 4, 256)), dtype=torch.float32)
    counts = torch.full((12,), 256, dtype=torch.int32)
    out = blend_forward_plain(packed, counts, cam, cfg)[0]
    gt = torch.cat([out[:, 0:3] + 0.5, out[:, 3:4] + 0.5], 1)
    far = (out[:, 4] - 0.99).abs() >= 1e-5
    gt_e, n = gt_without_loss_edges(packed, counts, gt, cam, cfg)
    assert n == int((~far).sum()) and torch.equal(gt_e[:, 3][far], gt[:, 3][far])
    gt[:, 0, :10] = out[:, 0, :10]  # a color residual of exactly 0
    gt_e, n = gt_without_loss_edges(packed, counts, gt, cam, cfg)
    assert bool((gt_e[:, 3, :10] == 0).all()) and n >= 120


def test_k1_rejects_exact_stop(tracking_inputs):
    """K1 runs the fast stop rule only and takes no exact-stop input: with
    ``exact_stop=True`` tracking goes to the exact fused kernel K7 instead
    (its plain version on the CPU), whose blend never takes a pixel's T
    below 1e-4."""
    _, packed, counts, gt_color, gt_depth = tracking_inputs
    cam = Camera(**CAM_KW)
    cfg = dataclasses.replace(RasterConfig(**CFG_KW), exact_stop=True)
    gt4 = tile_gt_images(_t(gt_color), _t(gt_depth), cam, cfg)
    img, dep, grads = tracking_loss_grad(_t(packed), _t(counts), gt4, cam, cfg, 0.7, 1.0, True)
    p_img, p_dep, p_grads = tracking_loss_grad_plain(_t(packed), _t(counts), gt4, cam, cfg,
                                                     0.7, 1.0, True)
    assert torch.equal(grads, p_grads) and float(img + dep) == float(p_img + p_dep)
    out = tracking_blend(_t(packed), _t(counts), cam, cfg)
    assert bool((out[:, 6] >= 1e-4).all())
