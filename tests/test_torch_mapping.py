"""The port's mapping step against the JAX package on the CPU (Pallas in
interpret mode for the flat render).

Tolerances:
- losses (L1, SSIM, mapping image loss, scale regularizers, the mapping
  loss in both modes): rtol 1e-5; their gradients 1e-4 of the largest;
- masked Adam over three steps: rtol 1e-5; prune, budget prune, compact,
  prefix writeback, window selection, densify and seeding: exact (masks,
  counts, selections) or 1e-6 (backprojected points);
- ``map_window`` over a 1-frame and a 3-frame window (``backend="pallas"``,
  fast stop, 3 and 4 iterations): the step-1 gradients within 2e-3 of each
  group's largest plus 2e-3 relative (the flat-blend gradient rtol; the
  port agrees with JAX's eager loss to 3e-5 of the largest, but the jitted
  JAX loss rounds single elements up to 1.2e-3 of the largest away from
  it); the per-iteration losses rtol 1e-3;
  the parameters within 2 lr x steps of each group (Adam's eps of 1e-15
  turns a gradient at rounding level into a step of +-lr).
The frame of each step is JAX's draw, recomputed here and handed to the
port's ``map_step``; the port's own ``map_window`` draws from a
``torch.Generator`` and must reproduce itself bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import MappingConfig as JMappingConfig
from gsorb_slam_tpu.core.transforms import pose_to_matrix as jpose_to_matrix
from gsorb_slam_tpu.ops import losses as JL
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster import render as jrender
from gsorb_slam_tpu.raster.binning import TileBins as JTileBins
from gsorb_slam_tpu.raster.binning import chunk_layout as jchunk_layout
from gsorb_slam_tpu.raster.pallas_raster import flat_pack_grad_aux as jflat_pack_grad_aux
from gsorb_slam_tpu.raster.pallas_raster import render_pallas_flat
from gsorb_slam_tpu.raster.types import RenderOutput as JRenderOutput
from gsorb_slam_tpu.slam import mapping as JM
from gsorb_slam_tpu.slam import window as JW
from gsorb_slam_tpu.splat import gaussians as JG
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import MappingConfig
from gsorb_slam_tpu_torch.interop import (
    gaussian_map_from_numpy,
    gaussian_map_to_numpy,
    window_frames_from_numpy,
)
from gsorb_slam_tpu_torch.ops import losses as L
from gsorb_slam_tpu_torch.raster.binning import TileBins
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput
from gsorb_slam_tpu_torch.slam import mapping as M
from gsorb_slam_tpu_torch.slam import window as W
from gsorb_slam_tpu_torch.splat import gaussians as G

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=2.0,
              exact_stop=False)
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
LRS = MappingConfig()
LR = {"means": LRS.lr_mean3d, "rgb": LRS.lr_rgb, "quats": LRS.lr_unnorm_rotation,
      "logit_opacities": LRS.lr_logit_opacities, "log_scales": LRS.lr_log_scales}


def _t(x):
    return torch.as_tensor(np.array(x))


def _jmap(scene, n, capacity, **extra):
    gm = JG.empty_map(capacity)
    return dataclasses.replace(gm, **scene, count=jnp.asarray(n, jnp.int32), **extra)


def _tmap(jgm):
    d = {f.name: getattr(jgm, f.name) for f in dataclasses.fields(jgm)}
    d = jax.tree.map(np.asarray, d)
    return gaussian_map_from_numpy(d, device="cpu")


def _assert_maps_equal(tgm, jgm, rtol=0.0, atol=0.0):
    t = gaussian_map_to_numpy(tgm)
    np.testing.assert_array_equal(t["active"], np.asarray(jgm.active))
    for k in (*KEYS[:-1], "count", "adam_t", "scene_radius", "max_z"):
        np.testing.assert_allclose(t[k], np.asarray(getattr(jgm, k)), rtol=rtol, atol=atol,
                                   err_msg=k)
    for mom in ("adam_m", "adam_v"):
        for k, v in getattr(jgm, mom).items():
            np.testing.assert_allclose(t[mom][k], np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{mom}.{k}")


def _render_output(color, depth, alpha, median=None):
    median = depth if median is None else median
    j = JRenderOutput(color=jnp.asarray(color), depth=jnp.asarray(depth),
                      alpha=jnp.asarray(alpha), median_depth=jnp.asarray(median),
                      final_t=jnp.asarray(1.0 - alpha), radii=jnp.zeros((4,)))
    t = RenderOutput(color=_t(color), depth=_t(depth), alpha=_t(alpha), median_depth=_t(median),
                     final_t=_t(1.0 - alpha), radii=torch.zeros(4))
    return j, t


def test_losses_match_jax(rng):
    pred = rng.uniform(size=(24, 32, 3)).astype(np.float32)
    target = rng.uniform(size=(24, 32, 3)).astype(np.float32)
    mask = rng.uniform(size=(24, 32)) < 0.6
    depth_p, depth_t = pred[..., 0] * 3, target[..., 0] * 3
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.as_tensor(m)
        pairs = (
            (JL.l1_mapping(jnp.asarray(pred), jnp.asarray(target), jm),
             L.l1_mapping(_t(pred), _t(target), tm)),
            (JL.ssim(jnp.asarray(pred), jnp.asarray(target), jm),
             L.ssim(_t(pred), _t(target), tm)),
            (JL.ssim(jnp.asarray(depth_p), jnp.asarray(depth_t), jm),
             L.ssim(_t(depth_p), _t(depth_t), tm)),
            (JL.mapping_image_loss(jnp.asarray(pred), jnp.asarray(target), 0.8, jm),
             L.mapping_image_loss(_t(pred), _t(target), 0.8, tm)),
        )
        for j, t in pairs:
            np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    # The masked-mean denominator counts an [H, W] mask once per channel.
    red = np.zeros_like(pred)
    red[..., 0] = 1.0
    assert float(L.l1_mapping(_t(red), _t(0 * red), torch.as_tensor(mask))) == pytest.approx(1 / 3)
    # SSIM's gradient.
    jg = jax.grad(lambda p: JL.ssim(p, jnp.asarray(target)))(jnp.asarray(pred))
    x = _t(pred).requires_grad_(True)
    (tg,) = torch.autograd.grad(L.ssim(x, _t(target)), x)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4 * float(np.abs(jg).max()))
    log_scales = np.log(rng.uniform(0.01, 0.3, (50, 3))).astype(np.float32)
    active = rng.uniform(size=50) < 0.7
    for j, t in zip(JL.scale_regularizers(jnp.asarray(log_scales), jnp.asarray(active), 1.5),
                    L.scale_regularizers(_t(log_scales), _t(active), 1.5)):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_adam_step_matches_jax(rng):
    scene = random_cloud_scene(rng, n=40, capacity=64)
    jgm = _jmap(scene, 40, 64)
    tgm = _tmap(jgm)
    mcfg = JMappingConfig()
    for _ in range(3):
        g = {k: rng.normal(size=np.shape(getattr(jgm, k))).astype(np.float32) for k in LR}
        jgm = JG.adam_step(jgm, jax.tree.map(jnp.asarray, g), JG.map_learning_rates(mcfg))
        tgm = G.adam_step(tgm, {k: _t(v) for k, v in g.items()},
                          G.map_learning_rates(MappingConfig()))
    _assert_maps_equal(tgm, jgm, rtol=1e-5, atol=1e-7)
    # Inactive rows stay frozen with zero moments.
    dead = ~np.asarray(scene["active"])
    assert not tgm.adam_m["means"].numpy()[dead].any()
    np.testing.assert_array_equal(tgm.means.numpy()[dead], np.asarray(scene["means"])[dead])


def test_prune_compact_writeback_match_jax(rng):
    scene = random_cloud_scene(rng, n=48, capacity=64)
    lo = np.asarray(scene["logit_opacities"]).copy()
    lo[[3, 7, 20]] = -6.0  # below the 0.005 prune threshold
    lo[10:20] = 0.25  # ties at the budget threshold
    scene["logit_opacities"] = jnp.asarray(lo)
    jgm = _jmap(scene, 48, 64, max_z=jnp.asarray(4.5, jnp.float32))
    tgm = _tmap(jgm)
    mcfg = JMappingConfig()
    j1, t1 = JM.prune_map(jgm, mcfg), M.prune_map(tgm, MappingConfig())
    _assert_maps_equal(t1, j1, rtol=1e-7)
    assert int(t1.n_active()) == 45
    for frac in (0.5, 0.6):
        _assert_maps_equal(G.prune_to_budget(t1, frac), JG.prune_to_budget(j1, frac))
    j2, t2 = JG.compact(JG.prune_to_budget(j1, 0.6)), G.compact(G.prune_to_budget(t1, 0.6))
    _assert_maps_equal(t2, j2)
    # An updated prefix written back into the full map.
    jp, tp = JG.prefix_view(j2, 32), G.prefix_view(t2, 32)
    jp = dataclasses.replace(jp, rgb=jp.rgb * 0.5, adam_t=jnp.asarray(7, jnp.int32))
    tp = dataclasses.replace(tp, rgb=tp.rgb * 0.5, adam_t=torch.tensor(7, dtype=torch.int32))
    t3 = G.prefix_writeback(t2, tp)
    _assert_maps_equal(t3, JG.prefix_writeback(j2, jp))
    assert torch.equal(t2.rgb[:32], _t(j2.rgb)[:32])  # the input map is unchanged


def test_window_selection_matches_jax():
    depth = np.full((48, 64), 2.0, np.float32)
    depth[:5, :7] = 0.0
    pts_j = JW.sample_reference_points(depth, 60, 60, 32, 24, 200, np.random.default_rng(1))
    pts_t = W.sample_reference_points(depth, 60, 60, 32, 24, 200, np.random.default_rng(1))
    np.testing.assert_array_equal(pts_t, pts_j)
    kfs = {}
    for mod in (JW, W):
        kfs[mod] = []
        for i in range(14):
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 0.04 * i
            T[2, 3] = 0.02 * (i % 3)
            kfs[mod].append(mod.KeyFrameMeta(kf_id=i, frame_id=i * 5, T_cw=T,
                                             ref_points_cam=pts_j))
        kfs[mod][6].rendered_num = 3
        kfs[mod][9].rendered_num = 1
        kfs[mod][4].is_bad = True
    for a, b in zip(kfs[JW], kfs[W]):
        args = (a.ref_points_cam, a.T_wc, b.T_cw, 60, 60, 32, 24, 64, 48)
        assert W.overlap_ratio(*args) == JW.overlap_ratio(*args)
        args = (kfs[JW][-1], a.T_cw, 60, 60, 32, 24, 64, 48)
        assert (W.need_new_keyframe_visual(kfs[W][-1], *args[1:])
                == JW.need_new_keyframe_visual(*args))
    for seed in (0, 1, 2):
        sel = [mod.select_window(kfs[mod], kfs[mod][-1], 60, 60, 60, 32, 24, 64, 48,
                                 np.random.default_rng(seed), n_covis=4, n_random_fill=4,
                                 n_recent_ba=2, n_anchor=2)
               for mod in (JW, W)]
        assert sel[1].kf_ids == sel[0].kf_ids and sel[1].anchor_ids == sel[0].anchor_ids
        assert [k.rendered_num for k in kfs[W]] == [k.rendered_num for k in kfs[JW]]


def _densify_inputs(case):
    """(render, gt color, gt depth, mcfg changes, sat_tiles) for a 32x48
    frame: a blank render with ties everywhere, or a render whose small
    depth errors have an even count with distinct middle values."""
    h, w = 32, 48
    gt_color = np.full((h, w, 3), 0.5, np.float32)
    gt_depth = np.full((h, w), 2.0, np.float32)
    color = np.zeros((h, w, 3), np.float32)
    if case == "nanmedian_even":
        # 600 pixels with depth error 0.001, 500 with 0.003, 100 with 0.015,
        # 336 with 0.5: the 1200 small errors have middle values 0.001 and
        # 0.003, so the threshold is 0.003 + 10 x 0.002 = 0.023 (0.013 with
        # the lower middle value, which would add the 0.015 pixels too).
        err = np.concatenate([np.full(600, 0.001), np.full(500, 0.003), np.full(100, 0.015),
                              np.full(336, 0.5)]).astype(np.float32)
        depth = gt_depth + np.random.default_rng(0).permutation(err).reshape(h, w)
        alpha = np.full((h, w), 0.9, np.float32)
        return (color, depth, alpha), gt_color, gt_depth, dict(max_adds_per_frame=0), None
    depth, alpha = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
    gt_depth[0, :40] = 5.0  # 40 pixels strictly worse than the rest
    if case == "max_adds_ties":
        # 40 strict winners, then a tie among all other pixels at the edge.
        return (color, depth, alpha), gt_color, gt_depth, dict(max_adds_per_frame=100), None
    sat = np.zeros(6, bool)
    sat[[0, 4]] = True
    return (color, depth, alpha), gt_color, gt_depth, dict(max_adds_per_frame=700), sat


@pytest.mark.parametrize("case", ["sat_tiles", "max_adds_ties", "nanmedian_even"])
def test_densify_frame_matches_jax(case):
    render, gt_color, gt_depth, mkw, sat = _densify_inputs(case)
    jout, tout = _render_output(*render)
    h, w = gt_depth.shape
    jc = JCamera(fx=40.0, fy=40.0, cx=w / 2, cy=h / 2, width=w, height=h)
    cam = Camera(fx=40.0, fy=40.0, cx=w / 2, cy=h / 2, width=w, height=h)
    T = jpose_to_matrix(jnp.array([1.0, 0.02, -0.01, 0.03]), jnp.array([0.1, -0.05, 0.2]))
    jgm = dataclasses.replace(JG.empty_map(4096), max_z=jnp.asarray(1.0, jnp.float32))
    rkw = dict(tile=16)
    jgm2, jn = JM.densify_frame(
        jgm, jout, jnp.asarray(gt_color), jnp.asarray(gt_depth), T, jc,
        dataclasses.replace(JMappingConfig(), **mkw),
        sat_tiles=None if sat is None else jnp.asarray(sat), rcfg=JRasterConfig(**rkw))
    tgm2, tn = M.densify_frame(
        _tmap(jgm), tout, _t(gt_color), _t(gt_depth), _t(T), cam,
        dataclasses.replace(MappingConfig(), **mkw),
        sat_tiles=None if sat is None else _t(sat), rcfg=RasterConfig(**rkw))
    assert int(tn) == int(jn) == {"sat_tiles": 700, "max_adds_ties": 100,
                                  "nanmedian_even": 336}[case]
    _assert_maps_equal(tgm2, jgm2, atol=1e-6)


def test_seed_from_frame_matches_jax(rng):
    color = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    depth = np.where(rng.uniform(size=(48, 64)) < 0.8, rng.uniform(1, 4, (48, 64)), 0.0)
    depth = depth.astype(np.float32)
    jc = JCamera(**CAM_KW)
    T = jpose_to_matrix(jnp.array([1.0, 0.01, 0.02, -0.01]), jnp.array([0.05, 0.0, -0.1]))
    jgm = JM.seed_from_frame(JG.empty_map(1024), jnp.asarray(color), jnp.asarray(depth), T, jc,
                             JMappingConfig(), 2)
    tgm = M.seed_from_frame(_tmap(JG.empty_map(1024)), _t(color), _t(depth), _t(T),
                            Camera(**CAM_KW), MappingConfig(), 2)
    assert int(tgm.count) == int(jgm.count) == int((depth[::2, ::2] > 0).sum())
    _assert_maps_equal(tgm, jgm, atol=1e-6)


@pytest.mark.parametrize("init_mode", [False, True])
def test_mapping_loss_matches_jax(rng, init_mode):
    scene = random_cloud_scene(rng, n=60, capacity=64)
    ls = np.asarray(scene["log_scales"]).copy()
    ls[:20] = np.log(0.3)  # isotropic (max / min ties) and beyond 0.1 radius
    ls[20:30, 0] = np.log(0.5)
    scene["log_scales"] = jnp.asarray(ls)
    jgm = _jmap(scene, 60, 64, scene_radius=jnp.asarray(2.0, jnp.float32))
    tgm = _tmap(jgm)
    h, w = 24, 32
    color = rng.uniform(size=(h, w, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (h, w)).astype(np.float32)
    alpha = np.where(rng.uniform(size=(h, w)) < 0.5, 0.995, 0.5).astype(np.float32)
    median = depth + rng.normal(0, 0.1, (h, w)).astype(np.float32)
    gt_c = rng.uniform(size=(h, w, 3)).astype(np.float32)
    gt_d = np.where(rng.uniform(size=(h, w)) < 0.8, rng.uniform(1, 3, (h, w)), 0).astype(np.float32)
    jout, tout = _render_output(color, depth, alpha, median)

    def jloss(c, d, s):
        o = dataclasses.replace(jout, color=c, depth=d)
        return JM._mapping_loss(dataclasses.replace(jgm, log_scales=s), o, jnp.asarray(gt_c),
                                jnp.asarray(gt_d), JMappingConfig(), init_mode)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jout.color, jout.depth, jgm.log_scales)
    x = [tout.color.requires_grad_(True), tout.depth.requires_grad_(True),
         tgm.log_scales.clone().requires_grad_(True)]
    tl = M.mapping_loss(dataclasses.replace(tgm, log_scales=x[2]), tout, _t(gt_c), _t(gt_d),
                        MappingConfig(), init_mode)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for t_g, j_g, x_i in zip(torch.autograd.grad(tl, x, allow_unused=True), jg, x):
        t_g = torch.zeros_like(x_i) if t_g is None else t_g  # init mode: no regularizer
        np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g),
                                   atol=1e-4 * float(np.abs(j_g).max()))


@pytest.fixture(scope="module")
def window_scene():
    """A 384-slot map of 300 splats, perturbed in colour and opacity, and
    three gt frames rendered from the unperturbed map, each binned from the
    perturbed map at its pose (the System's keyframe bins)."""
    rng = np.random.default_rng(0)
    scene = random_cloud_scene(rng, n=300, capacity=384, spread=1.6)
    jc, jcfg = JCamera(**CAM_KW), JRasterConfig(**CFG_KW)
    poses = [jnp.eye(4),
             jpose_to_matrix(jnp.array([1.0, 0.01, -0.01, 0.005]), jnp.array([0.02, -0.01, 0.0])),
             jpose_to_matrix(jnp.array([1.0, -0.01, 0.0, 0.01]), jnp.array([-0.02, 0.0, 0.01]))]
    pert = dict(scene)
    pert["rgb"] = jnp.clip(scene["rgb"] + rng.normal(0, 0.1, (384, 3)).astype(np.float32), 0, 1)
    pert["logit_opacities"] = scene["logit_opacities"] + rng.normal(0, 0.5, 384).astype(np.float32)

    @jax.jit
    def gt_and_bins(P):
        o = jrender(*(scene[k] for k in KEYS), P, jc, jcfg)
        bins = jbin(jpreprocess(*(pert[k] for k in KEYS), P, jc), jc, jcfg)
        return o.color, jnp.where(o.alpha > 0.5, o.median_depth, 0.0), bins

    colors, depths, bins = zip(*(gt_and_bins(P) for P in poses))
    jgm = _jmap(pert, 300, 384, max_z=jnp.asarray(4.0, jnp.float32),
                scene_radius=jnp.asarray(4.0 / 3.0, jnp.float32))
    return jgm, colors, depths, poses, bins


def _window(window_scene, n_frames):
    """The window of the first ``n_frames`` frames, by JAX and by the port."""
    jgm, colors, depths, poses, bins = window_scene
    frames = JM.build_window_frames(colors, depths, poses, bins, n_frames, 3)
    tbins = [TileBins(_t(b.indices), _t(b.counts), _t(b.n_dropped)) for b in bins]
    t_frames = M.build_window_frames([np.asarray(c) for c in colors], depths, poses, tbins,
                                     n_frames, 3, device="cpu")
    return jgm, frames, t_frames


@pytest.mark.parametrize("n_frames,iters,seed", [(1, 3, 0), (3, 4, 1)])
def test_map_window_matches_jax(window_scene, n_frames, iters, seed):
    jgm, frames, t_frames = _window(window_scene, n_frames)
    jc, cam = JCamera(**CAM_KW), Camera(**CAM_KW)
    jcfg = JRasterConfig(**CFG_KW, backend="pallas")
    cfg, mcfg, jmcfg = RasterConfig(**CFG_KW), MappingConfig(), JMappingConfig()
    key = jax.random.PRNGKey(seed)
    jgm2, jlosses = jax.jit(lambda gm, k: JM.map_window(
        gm, frames, k, jc, jmcfg, jcfg, num_iters=iters, chunk_budget=64))(jgm, key)
    ks = [int(jax.random.randint(k, (), 0, n_frames)) for k in jax.random.split(key, iters)]
    assert len(set(ks)) == n_frames

    tfr = window_frames_from_numpy(jax.tree.map(np.asarray, frames._asdict()), device="cpu")
    for f in ("colors", "depths", "poses", "bins_indices", "bins_counts"):
        assert torch.equal(getattr(t_frames, f), getattr(tfr, f)), f
    assert t_frames.n_frames == tfr.n_frames == n_frames
    tgm = _tmap(jgm)
    layouts = M.window_layouts(tfr, tgm.capacity, cam, cfg, 64)

    # Step-1 gradients against JAX's own loss function of map_window.
    k0 = ks[0]
    jcb = jchunk_layout(JTileBins(frames.bins_indices[k0], frames.bins_counts[k0],
                                  jnp.zeros((), jnp.int32)), 12, 64, 64)
    jaux = jflat_pack_grad_aux(jcb.indices, 384)

    def jloss(params):
        g2 = dataclasses.replace(jgm, **params)
        prep = jpreprocess(g2.means, g2.rgb, g2.quats, g2.logit_opacities, g2.log_scales,
                           g2.active, frames.poses[k0], jc)
        out = render_pallas_flat(prep, jcb, jc, jcfg, pack_aux=jaux)
        return JM._mapping_loss(g2, out, frames.colors[k0], frames.depths[k0], jmcfg, False)

    jl0, jg0 = jax.jit(jax.value_and_grad(jloss))(jgm.params())
    tl0, tg0 = M.map_loss_and_grads(tgm, tfr, k0, layouts[k0], cam, mcfg, cfg)
    np.testing.assert_allclose(float(tl0), float(jl0), rtol=1e-5)
    for k, g in tg0.items():
        jg = np.asarray(jg0[k])
        np.testing.assert_allclose(g.numpy(), jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max(),
                                   err_msg=k)

    losses = []
    for k in ks:
        tgm, loss = M.map_step(tgm, tfr, k, layouts, cam, mcfg, cfg)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-3)
    for k, lr in LR.items():
        np.testing.assert_allclose(getattr(tgm, k).numpy(), np.asarray(getattr(jgm2, k)),
                                   atol=2 * lr * iters, rtol=0, err_msg=k)
    assert int(tgm.adam_t) == int(jgm2.adam_t) == iters

    # The port's own loop: frames drawn by a torch.Generator, reproducible.
    runs = [M.map_window(_tmap(jgm), tfr, torch.Generator().manual_seed(5), cam, mcfg, cfg,
                         num_iters=iters, chunk_budget=64) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    for k in KEYS:
        assert torch.equal(getattr(runs[0][0], k), getattr(runs[1][0], k)), k
    with pytest.raises(ValueError, match="chunk budget"):
        M.map_window(_tmap(jgm), tfr, torch.Generator(), cam, mcfg, cfg, num_iters=1,
                     chunk_budget=4)


def test_window_chunk_budget():
    """The System's rule: the most live chunks of any frame plus 64, up to a
    multiple of 1024, between 1024 and 2^15."""
    c = torch.tensor([[300, 0, 64], [64, 1, 0]], dtype=torch.int32)
    assert M.window_chunk_budget(c, 64) == 1024
    c = torch.full((2, 1200), 129, dtype=torch.int32)  # 3600 chunks a frame
    assert M.window_chunk_budget(c, 64) == 4096
    assert M.window_chunk_budget(c * 16, 64) == 1 << 15
