"""The tracking loop's eager paths against the loop as it ran before its
iterations could replay as CUDA graphs, bit for bit, and the pieces those
graphs are made of (``slam/track_graph.py``), and the graph registry that
tracking and mapping share (``utils/cuda_graphs.py``).

- ``track_frame`` on CPU tensors, and ``pose_loop`` on tensor operands (as
  the tile-sharded ``parallel_track_frame`` hands it), against
  :func:`_reference_track_frame` / :func:`_reference_pose_loop`, which keep
  the loop with its update written inline; neither makes a graph;
- ``pose_step`` (the loop's update, ``G_step``'s body) and its in-place
  form on fixed buffers (``StepState.copy_``) against the inline update;
- ``tracking_loss_grad(out=)`` and the keyed registry, through
  ``frame_graph`` and ``map_graph.window_graph``.

CPU only; imports neither jax nor the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import TrackingConfig, default_rebin_iters
from gsorb_slam_tpu_torch.core.transforms import matrix_to_pose, pose_to_matrix
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess, render
from gsorb_slam_tpu_torch.raster.blend_kernels import tile_gt_images, tracking_loss_grad
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel
from gsorb_slam_tpu_torch.slam import map_graph as MG
from gsorb_slam_tpu_torch.slam import mapping as M
from gsorb_slam_tpu_torch.slam import track_graph as TG
from gsorb_slam_tpu_torch.slam import tracking as T
from gsorb_slam_tpu_torch.splat.gaussians import (
    PoseState,
    empty_map,
    init_pose_state,
    pose_adam_step,
)
from gsorb_slam_tpu_torch.utils import cuda_graphs as CG

torch.set_num_threads(1)

CAM = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
RCFG = RasterConfig(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=4.0,
                    exact_stop=False)
ITERS, REBIN = 12, (4, 8)


@pytest.fixture(autouse=True)
def no_graphs():
    CG._GRAPHS.clear()
    yield
    CG._GRAPHS.clear()


def _scene(n=400, capacity=512):
    """A map of ``n`` splats, its render at the identity as the gt, a
    perturbed initial pose and 24 matches (16 valid) of map points seen at
    the identity."""
    rng = np.random.default_rng(7)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                      rng.uniform(1.5, 3.5, n)], -1)
    gm = empty_map(capacity, device="cpu")
    live = lambda full, rows: torch.cat([rows, full[n:]])
    gm = dataclasses.replace(
        gm,
        means=live(gm.means, f32(means)),
        rgb=live(gm.rgb, f32(rng.uniform(0, 1, (n, 3)))),
        quats=live(gm.quats, f32(rng.normal(size=(n, 4)))),
        logit_opacities=live(gm.logit_opacities, f32(np.full(n, 4.0))),
        log_scales=live(gm.log_scales, f32(np.log(rng.uniform(0.03, 0.08, (n, 3))))),
        active=torch.arange(capacity) < n,
        count=torch.tensor(n, dtype=torch.int32),
    )
    with torch.no_grad():
        out = render(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales, gm.active,
                     torch.eye(4), CAM, RCFG)
    gt_depth = torch.where(out.alpha > 0.5, out.median_depth, 0.0)
    T_init = pose_to_matrix(f32([1.0, 0.004, -0.003, 0.005]), f32([0.015, -0.01, 0.012]))
    world = f32(means[:24])
    uv = torch.stack([CAM.fx * world[:, 0] / world[:, 2] + CAM.cx,
                      CAM.fy * world[:, 1] / world[:, 2] + CAM.cy], -1)
    matches = T.FeatureMatches(obs_uv=uv + f32(rng.normal(0, 0.5, (24, 2))), world=world,
                               inv_sigma2=f32(rng.uniform(0.5, 1.0, 24)),
                               valid=torch.arange(24) < 16)
    return gm, T_init, out.color, gt_depth, matches


def _reference_track_frame(gm, T_cw_init, gt_color, gt_depth, matches, cam, tcfg, rcfg,
                           num_iters=None, scale_modifier=1.0, rebin_iters=None):
    """``track_frame`` with square tiles, as it was with an eager loop only."""

    def episode(T_cw):
        prep = preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                          gm.active, (T_cw_init if T_cw is None else T_cw).detach(), cam,
                          scale_modifier)
        b = bin_gaussians(prep, cam, rcfg)
        raw = pack_raw_instances(gm.means, gm.rgb, gm.quats, gm.logit_opacities,
                                 gm.log_scales, gm.active, b)
        return raw, b.counts, gt_tiles

    gt_tiles = tile_gt_images(gt_color, gt_depth, cam, rcfg)
    use_features = bool(matches.valid.any())

    def value_and_grad(quat, trans, inliers, raw, counts, gt4):
        q = quat.detach().requires_grad_(True)
        t = trans.detach().requires_grad_(True)
        with torch.enable_grad():
            T_cw = pose_to_matrix(q, t)
            screen = preprocess_instances_kernel(raw, rt_from_matrix(T_cw), cam, scale_modifier)
            img_l1, dep_l1, d_screen = tracking_loss_grad(
                screen.detach(), counts, gt4, cam, rcfg,
                tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth,
            )
            loss = img_l1 + dep_l1
            if use_features:
                chi2 = T.reprojection_chi2(T_cw, matches, cam)
                chi2 = torch.where(matches.valid & inliers, chi2, torch.zeros_like(chi2))
                chi2_l = tcfg.feature_weight * chi2.sum()
                torch.autograd.backward([screen, chi2_l], [d_screen, torch.ones_like(chi2_l)])
                loss = loss + chi2_l.detach()
            else:
                torch.autograd.backward(screen, d_screen)
        return loss, q.grad, t.grad

    return _reference_pose_loop(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, episode,
                                value_and_grad)


def _reference_pose_loop(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, episode,
                         value_and_grad):
    """``pose_loop`` with its update written inline."""
    num_iters = int(num_iters or tcfg.num_iters)
    if rebin_iters is None:
        rebin_iters = tcfg.rebin_iters
    if rebin_iters is None:
        rebin_iters = default_rebin_iters(num_iters)
    rebin_iters = tuple(r for r in rebin_iters if 0 < r < num_iters)
    quat0, trans0 = matrix_to_pose(T_cw_init.detach())
    ps = init_pose_state(quat0, trans0)
    with torch.no_grad():
        operands = episode(None)
    regate_iter = num_iters // 2
    inliers = torch.ones_like(matches.valid)
    best_q, best_t = ps.quat, ps.trans
    best_loss = torch.full((), float("inf"))
    last_loss = torch.zeros(())
    it = 0
    n_applied = 0
    for i, seg_end in enumerate(list(sorted(rebin_iters)) + [num_iters]):
        if i > 0 and it < num_iters:
            with torch.no_grad():
                operands = episode(pose_to_matrix(ps.quat, ps.trans))
        while it < seg_end:
            loss, gq, gt_ = value_and_grad(ps.quat, ps.trans, inliers, *operands)
            with torch.no_grad():
                if it == regate_iter:
                    chi2_now = T.reprojection_chi2(pose_to_matrix(ps.quat, ps.trans), matches,
                                                   cam)
                    inliers = chi2_now < T.CHI2_INLIER
                improved = torch.isfinite(loss) & (loss < best_loss)
                best_q = torch.where(improved, ps.quat, best_q)
                best_t = torch.where(improved, ps.trans, best_t)
                best_loss = torch.where(improved, loss, best_loss)
                converged = (tcfg.early_stop_delta > 0.0
                             and bool((last_loss - loss).abs() < tcfg.early_stop_delta))
                it = num_iters if converged else it + 1
                ps = pose_adam_step(ps, gq, gt_, tcfg)
                last_loss = loss
                n_applied += 1
    with torch.no_grad():
        T_best = pose_to_matrix(best_q, best_t)
        return T.TrackResult(T_cw=T_best, loss=best_loss,
                             n_iters=torch.tensor(n_applied, dtype=torch.int32),
                             chi2=T.reprojection_chi2(T_best, matches, cam),
                             inliers=inliers & matches.valid)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    for f in ("T_cw", "loss", "n_iters", "chi2", "inliers"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f


@pytest.mark.parametrize("use_features", [False, True])
@pytest.mark.parametrize("early_stop", [False, True])
def test_track_frame_on_cpu_is_the_eager_loop(use_features, early_stop, monkeypatch):
    """CPU ``track_frame`` over rebins and the re-gate (and, with
    ``early_stop``, a stop that fires midway) equals the inline loop bit
    for bit, and makes no graph."""
    gm, T_init, color, depth, matches = _scene()
    if not use_features:
        matches = matches._replace(valid=torch.zeros_like(matches.valid))
    tcfg = TrackingConfig(num_iters=ITERS, early_stop_delta=0.0)
    if early_stop:
        # The median |dloss| of the full run, so the stop fires after the
        # first iteration and before the last.
        losses = []
        with monkeypatch.context() as m:
            m.setattr(T, "tracking_loss_grad",
                      lambda *a, **k: losses.append(tracking_loss_grad(*a, **k)) or losses[-1])
            T.track_frame(gm, T_init, color, depth, matches, CAM, tcfg, RCFG, rebin_iters=REBIN)
        tot = torch.stack([a + b for a, b, _ in losses])
        d = (tot[1:] - tot[:-1]).abs()
        tcfg = dataclasses.replace(tcfg, early_stop_delta=float(d.median()))
    want = _reference_track_frame(gm, T_init, color, depth, matches, CAM, tcfg, RCFG,
                                  rebin_iters=REBIN)
    got = T.track_frame(gm, T_init, color, depth, matches, CAM, tcfg, RCFG, rebin_iters=REBIN)
    _assert_same(got, want)
    n = int(got.n_iters)
    assert (1 < n < ITERS) if early_stop else n == ITERS
    assert not CG._GRAPHS


@pytest.mark.parametrize("delta,rebins", [(0.0, (3, 7)), (0.05, ())])
def test_pose_loop_on_tensor_operands_is_the_eager_loop(delta, rebins):
    """``pose_loop`` handed tensor operands (the tile-sharded path's) on a
    quadratic pull toward a target pose equals the inline loop bit for bit;
    each episode's operands reach ``value_and_grad`` unchanged."""
    target_q = torch.tensor([0.99, 0.05, -0.03, 0.02])
    target_t = torch.tensor([0.1, -0.2, 0.05])
    matches = _scene()[4]
    seen = {"got": [], "want": []}

    def make(log):
        def episode(T_cw):
            shift = torch.zeros(3) if T_cw is None else 0.01 * T_cw[:3, 3]
            return target_t + shift, torch.tensor(float(len(log)))

        def value_and_grad(quat, trans, inliers, tgt, tag):
            q = quat.detach().requires_grad_(True)
            t = trans.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = ((q - target_q) ** 2).sum() + ((t - tgt) ** 2).sum() * (1 + tag)
                loss = loss + inliers.float().sum() * 1e-3
                loss.backward()
            log.append((quat.clone(), trans.clone(), inliers.clone(), tag.clone()))
            return loss.detach(), q.grad, t.grad
        return episode, value_and_grad

    tcfg = TrackingConfig(num_iters=10, early_stop_delta=delta, lr_cam_quat=0.05,
                          lr_cam_trans=0.05)
    T_init = torch.eye(4)
    want = _reference_pose_loop(T_init, matches, CAM, tcfg, None, rebins, *make(seen["want"]))
    got = T.pose_loop(T_init, matches, CAM, tcfg, None, rebins, *make(seen["got"]))
    _assert_same(got, want)
    assert len(seen["got"]) == len(seen["want"]) == int(got.n_iters)
    for a, b in zip(seen["got"], seen["want"]):
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))
    assert not CG._GRAPHS


# (loss, best loss, last loss, early_stop_delta)
STEP_CASES = {
    "improved": (2.0, 3.0, 2.5, 1e-3),
    "not_improved": (4.0, 3.0, 2.5, 1e-3),
    "nan_loss": (float("nan"), 3.0, 2.5, 1e-3),
    "first_iteration": (2.0, float("inf"), 0.0, 1e-3),
    "stop_fires": (2.0, 3.0, 2.0005, 1e-3),
    "no_stop_rule": (2.0, 3.0, 2.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_pose_step_is_the_inline_update(case):
    """``pose_step`` (functional, the eager loop's) and its in-place form on
    fixed buffers (``G_step``'s body) give the inline update's pose, Adam
    state, best pose and loss, last loss and stop flag, bit for bit."""
    loss, best, last, delta = (torch.tensor(v, dtype=torch.float32) for v in STEP_CASES[case])
    tcfg = TrackingConfig(early_stop_delta=float(delta))
    rng = np.random.default_rng(3)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    ps = PoseState(quat=f32(4), trans=f32(3), m_quat=f32(4), v_quat=f32(4).abs(),
                   m_trans=f32(3), v_trans=f32(3).abs(), t=torch.tensor(5, dtype=torch.int32))
    best_q, best_t, gq, gt_ = f32(4), f32(3), f32(4), f32(3)

    improved = torch.isfinite(loss) & (loss < best)
    want = dict(best_q=torch.where(improved, ps.quat, best_q),
                best_t=torch.where(improved, ps.trans, best_t),
                best_loss=torch.where(improved, loss, best), last_loss=loss,
                stop=(last - loss).abs() < delta)
    want_ps = pose_adam_step(ps, gq, gt_, tcfg)

    st = T.StepState(ps=ps, best_q=best_q, best_t=best_t, best_loss=best, last_loss=last,
                     stop=torch.tensor(False))
    bufs = st.clone()
    ptrs = [t.data_ptr() for t in bufs.tensors()]
    bufs.copy_(T.pose_step(bufs, loss, gq, gt_, tcfg))
    assert [t.data_ptr() for t in bufs.tensors()] == ptrs
    for got in (T.pose_step(st, loss, gq, gt_, tcfg), bufs):
        for f in dataclasses.fields(want_ps):
            assert torch.equal(_bits(getattr(got.ps, f.name)), _bits(getattr(want_ps, f.name)))
        for k, v in want.items():
            assert torch.equal(_bits(getattr(got, k)), _bits(v)), k
    assert bool(want["stop"]) == (case == "stop_fires")


def test_tracking_loss_grad_writes_out():
    """``out=`` receives the cotangent block and is returned as it; the
    losses and the block are those of the call without it."""
    gm, T_init, color, depth, _ = _scene()
    with torch.no_grad():
        prep = preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                          gm.active, T_init, CAM)
        b = bin_gaussians(prep, CAM, RCFG)
        raw = pack_raw_instances(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                                 gm.active, b)
        screen = preprocess_instances_kernel(raw, rt_from_matrix(T_init), CAM)
    gt4 = tile_gt_images(color, depth, CAM, RCFG)
    args = (screen, b.counts, gt4, CAM, RCFG, 0.7, 1.0, True)
    want = tracking_loss_grad(*args)
    out = torch.full_like(want[2], float("nan"))
    got = tracking_loss_grad(*args, out=out)
    assert got[2] is out
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def _graph_makers():
    """``{owner: make(flag, observed, n)}``: a graph asked of the track or the
    map registry front (``frame_graph`` / ``window_graph``) on CPU tensors,
    for a pack of ``n`` tiles or ``n`` draws, with flag ``use_features`` or
    ``init_mode``. The bodies never run."""
    gm, T_init, color, depth, matches = _scene()
    raw = torch.zeros(12, 16, 256)
    counts = torch.zeros(12, dtype=torch.int32)
    gt4 = torch.zeros(12, 4, 256)
    with torch.no_grad():
        bins = bin_gaussians(preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities,
                                        gm.log_scales, gm.active, T_init, CAM), CAM, RCFG)
    frames = M.build_window_frames([color], [depth], [T_init], [bins], 1, 2, device="cpu")
    layouts = M.window_layouts(frames, gm.capacity, CAM, RCFG, RCFG.chunk_budget)
    return {
        "track": lambda flag, observed, n=12: TG.frame_graph(
            raw[:n], counts[:n], gt4[:n], matches, flag, observed, None, None, None),
        "map": lambda flag, observed, n=12: MG.window_graph(
            gm, frames, layouts, list(range(n)), flag, observed, None, None),
    }


@pytest.mark.parametrize("owner", ["track", "map"])
def test_frame_graph_registry_keeps_the_newest_per_slot(owner):
    """A call with the same key gets the graph kept for its slot, ``(owner,
    device, flag)``; a new key replaces it; the other flag and the other
    owner have slots of their own. ``graph_path`` is false on CPU tensors
    and for paired tracking."""
    make = _graph_makers()
    other = "map" if owner == "track" else "track"
    kept = lambda: {slot: g for slot, (_, g) in CG._GRAPHS.items()}
    dev = torch.device("cpu")
    a = make[owner](True, (CAM, 1.0))
    assert make[owner](True, (CAM, 1.0)) is a
    b = make[owner](True, (CAM, 0.5))
    assert b is not a and kept() == {(owner, dev, True): b}
    c = make[owner](False, (CAM, 1.0), n=6 if owner == "track" else 100)
    d = make[other](True, (CAM, 0.5))
    assert kept() == {(owner, dev, True): b, (owner, dev, False): c, (other, dev, True): d}
    if owner == "track":
        assert c.d_screen.shape == (6, 16, 256) and c.inliers.shape == (24,)
    else:
        assert c.draws.shape == (128,) and c.layouts.table.shape[0] == 2
    gm = _scene()[0]
    assert not T.graph_path(gm, RCFG)
    assert not T.graph_path(gm, dataclasses.replace(RCFG, paired=True))
