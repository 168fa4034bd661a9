"""The pose-tracking iteration's CUDA graphs (``slam/track_graph.py``)
against the eager loop, on the card.

Marked ``cuda``: without a CUDA device every test skips. This file imports
neither jax nor the JAX package: ``python -m pytest --noconftest -m cuda
tests/test_torch_track_graph.py``. ``track_frame`` on CUDA tensors with
square tiles replays the graphs; with ``tracking.graph_path`` patched to
false it runs the eager loop on the same tensors. The two run the same
kernels in the same order with no float atomics, so the pose, every
iteration's pose, inlier gate, loss and gradients, each episode's pose and
every K1 cotangent agree bit for bit. They are recorded as the benchmark's
check records them: by wrapping ``pose_loop`` (and the ``episode`` and
``value_and_grad`` it is handed) and ``tracking_loss_grad`` at Python level.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
from gsorb_slam_tpu_torch.raster import RasterConfig, render
from gsorb_slam_tpu_torch.slam import tracking as T
from gsorb_slam_tpu_torch.splat.gaussians import empty_map
from gsorb_slam_tpu_torch.utils import cuda_graphs as CG
from gsorb_slam_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

CAM = Camera(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
RCFG = RasterConfig(tile=16, tile_capacity=512, max_dup=16, chunk=128, dilate_px=2.0,
                    exact_stop=False)
ITERS = 200  # rebins at 8, 40 and 120, the re-gate at 100
COUNTERS = ("track_graph_captures", "track_graph_replays")
KERNELS = ("fused_track_fast", "preprocess_fwd", "preprocess_bwd")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    CG._GRAPHS.clear()
    yield torch.device("cuda")
    CG._GRAPHS.clear()


def _scene(dev, n=3000, capacity=4096):
    """A map of ``n`` splats, its render at the identity as the gt, a
    perturbed initial pose and 64 matches of map points: 48 valid, 8 of
    those 12 px off (the re-gate drops them)."""
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(0.8, 4.0, n)], -1)
    gm = empty_map(capacity, device=dev)
    live = lambda full, rows: torch.cat([rows, full[n:]])
    gm = dataclasses.replace(
        gm,
        means=live(gm.means, f32(means)),
        rgb=live(gm.rgb, f32(rng.uniform(0, 1, (n, 3)))),
        quats=live(gm.quats, f32(rng.normal(size=(n, 4)))),
        logit_opacities=live(gm.logit_opacities, f32(rng.uniform(0.0, 3.0, n))),
        log_scales=live(gm.log_scales, f32(np.log(rng.uniform(0.01, 0.05, (n, 3))))),
        active=torch.arange(capacity, device=dev) < n,
        count=torch.tensor(n, dtype=torch.int32, device=dev),
        max_z=f32(4.0), scene_radius=f32(4.0 / 3.0),
    )
    with torch.no_grad():
        out = render(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales, gm.active,
                     torch.eye(4, device=dev), CAM, RCFG)
    gt_depth = torch.where(out.alpha > 0.5, out.median_depth, 0.0)
    T_init = pose_to_matrix(f32([1.0, 0.01, -0.008, 0.006]), f32([0.03, -0.02, 0.015]))
    world = means[:64]
    uv = np.stack([CAM.fx * world[:, 0] / world[:, 2] + CAM.cx,
                   CAM.fy * world[:, 1] / world[:, 2] + CAM.cy], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    uv[:8] += 12.0
    matches = T.FeatureMatches(obs_uv=f32(uv), world=f32(world),
                               inv_sigma2=f32(rng.uniform(0.5, 1.0, 64)),
                               valid=torch.arange(64, device=dev) < 48)
    return gm, T_init, out.color, gt_depth, matches


class Recorder:
    """What the benchmark's check records of a solve, for every iteration:
    the pose, inlier gate, loss and gradients each ``value_and_grad``
    call returns, each episode's pose, and each ``tracking_loss_grad``
    call's cotangent under the number of iterations before it."""

    def __init__(self, monkeypatch):
        self.iters, self.episodes, self.d_screen = [], [], {}
        loop, loss_grad = T.pose_loop, T.tracking_loss_grad

        def pose_loop(T_init, matches, cam, tcfg, num_iters, rebin_iters, episode, vg):
            def ep(T_cw):
                pose = T_init if T_cw is None else T_cw
                self.episodes.append((len(self.iters), pose.detach().clone()))
                return episode(T_cw)

            def v(quat, trans, inliers, *operands):
                loss, gq, gt_ = vg(quat, trans, inliers, *operands)
                self.iters.append([x.detach().clone() for x in (quat, trans, inliers, loss, gq,
                                                                 gt_)])
                return loss, gq, gt_

            return loop(T_init, matches, cam, tcfg, num_iters, rebin_iters, ep, v)

        def tracking_loss_grad(*a, **kw):
            img, dep, d_screen = loss_grad(*a, **kw)
            self.d_screen[len(self.iters)] = d_screen.detach().clone()
            return img, dep, d_screen

        monkeypatch.setattr(T, "pose_loop", pose_loop)
        monkeypatch.setattr(T, "tracking_loss_grad", tracking_loss_grad)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _solve(monkeypatch, scene, tcfg, rcfg=RCFG, eager=False, **kw):
    """``track_frame`` on the scene, recorded; ``eager``: the eager loop."""
    gm, T_init, color, depth, matches = scene
    with monkeypatch.context() as m:
        if eager:
            m.setattr(T, "graph_path", lambda gm, rcfg: False)
        rec = Recorder(m)
        _build.reset_launches()
        with torch.no_grad():
            res = T.track_frame(gm, T_init, color, depth, matches, CAM, tcfg,
                                T.tracking_raster_config(rcfg), **kw)
        torch.cuda.synchronize()
    return res, rec, dict(_build.launches)


def _assert_same_solve(got, want, k1=True):
    """Results and records bit for bit; ``k1``: a K1 / K7 cotangent was
    recorded at every iteration (paired tracking calls K8's function)."""
    (res_g, rec_g, _), (res_w, rec_w, _) = got, want
    for f in ("T_cw", "loss", "n_iters", "chi2", "inliers"):
        assert _same(getattr(res_g, f), getattr(res_w, f)), f
    assert len(rec_g.iters) == len(rec_w.iters) == int(res_w.n_iters)
    for i, (a, b) in enumerate(zip(rec_g.iters, rec_w.iters)):
        for name, x, y in zip(("q", "t", "inliers", "loss", "gq", "gt"), a, b):
            assert _same(x, y), (i, name)
    assert [i for i, _ in rec_g.episodes] == [i for i, _ in rec_w.episodes]
    for (_, x), (_, y) in zip(rec_g.episodes, rec_w.episodes):
        assert _same(x, y)
    n_cotangents = len(rec_w.iters) if k1 else 0
    assert sorted(rec_g.d_screen) == sorted(rec_w.d_screen) == list(range(n_cotangents))
    for i in rec_w.d_screen:
        assert _same(rec_g.d_screen[i], rec_w.d_screen[i]), i


@pytest.mark.parametrize("use_features", [True, False])
def test_track_graph_matches_eager_loop(dev, monkeypatch, use_features):
    """A 200-iteration solve (rebins at 8 / 40 / 120, the re-gate at 100)
    against the eager loop, bit for bit: a first call (one eager iteration,
    the capture, 199 replays) and a second (200 replays). K1, K2f and K2b
    count one launch an iteration."""
    scene = _scene(dev)
    if not use_features:
        scene = scene[:4] + (scene[4]._replace(valid=torch.zeros_like(scene[4].valid)),)
    tcfg = TrackingConfig(num_iters=ITERS, early_stop_delta=0.0)
    want = _solve(monkeypatch, scene, tcfg, eager=True)
    assert [i for i, _ in want[1].episodes] == [0, 8, 40, 120]
    if use_features:  # the re-gate dropped the far matches
        assert bool(want[1].iters[100][2][:8].all()) and not bool(want[1].iters[101][2][:8].any())
    tracer = trace.Tracer(counters=COUNTERS)
    for call, replays in ((1, ITERS - 1), (2, 2 * ITERS - 1)):
        with tracer.current():
            got = _solve(monkeypatch, scene, tcfg)
        _assert_same_solve(got, want)
        assert all(got[2][k] == ITERS for k in KERNELS), got[2]
        assert tracer.totals["track_graph_captures"] == 1
        assert tracer.totals["track_graph_replays"] == replays
    assert [(o, d.type, f) for o, d, f in CG._GRAPHS] == [("track", "cuda", use_features)]


def test_track_graph_early_stop_matches_eager_loop(dev, monkeypatch):
    """A solve whose early stop fires midway, against the eager loop bit
    for bit, captured and then replayed from its first iteration."""
    scene = _scene(dev)
    tcfg = TrackingConfig(num_iters=ITERS, early_stop_delta=0.0)
    full = _solve(monkeypatch, scene, tcfg, eager=True)[1]
    loss = torch.stack([it[3] for it in full.iters])
    tcfg = dataclasses.replace(tcfg, early_stop_delta=float((loss[1:] - loss[:-1]).abs().median()))
    want = _solve(monkeypatch, scene, tcfg, eager=True)
    assert 1 < int(want[0].n_iters) < ITERS
    for _ in range(2):
        got = _solve(monkeypatch, scene, tcfg)
        _assert_same_solve(got, want)
        assert all(got[2][k] == int(want[0].n_iters) for k in KERNELS)


def test_track_graph_keys(dev, monkeypatch):
    """A new key captures again and replaces the graph of its ``(device,
    use_features)``: another ``scale_modifier``, K7 (``exact_stop``, the
    same graphs with K7 between them) and, in a slot of its own, a solve
    without features. Paired tracking (K8) stays eager and makes no graph.
    Each is the eager loop's, bit for bit."""
    scene = _scene(dev)
    tcfg = TrackingConfig(num_iters=24, early_stop_delta=0.0)
    no_features = scene[:4] + (scene[4]._replace(valid=torch.zeros_like(scene[4].valid)),)
    exact = dataclasses.replace(RCFG, exact_stop=True)
    calls = [(scene, RCFG, 1.0, 1), (scene, RCFG, 0.9, 2), (scene, exact, 1.0, 3),
             (scene, exact, 1.0, 3), (no_features, exact, 1.0, 4)]
    tracer = trace.Tracer(counters=COUNTERS)
    for sc, rcfg, sm, captures in calls:
        want = _solve(monkeypatch, sc, tcfg, rcfg, eager=True, scale_modifier=sm)
        with tracer.current():
            got = _solve(monkeypatch, sc, tcfg, rcfg, scale_modifier=sm)
        _assert_same_solve(got, want)
        k1 = "fused_track_exact" if rcfg.exact_stop else "fused_track_fast"
        assert got[2][k1] == got[2]["preprocess_fwd"] == got[2]["preprocess_bwd"] == 24
        assert tracer.totals["track_graph_captures"] == captures
    assert sorted((o, d.type, f) for o, d, f in CG._GRAPHS) == [("track", "cuda", False),
                                                               ("track", "cuda", True)]

    paired = dataclasses.replace(RCFG, paired=True)
    CG._GRAPHS.clear()
    want = _solve(monkeypatch, scene, tcfg, paired, eager=True)
    with tracer.current():
        got = _solve(monkeypatch, scene, tcfg, paired)
    _assert_same_solve(got, want, k1=False)
    assert got[2]["paired_track"] == 24 and not CG._GRAPHS
    assert tracer.totals["track_graph_captures"] == 4


def test_track_graph_captures_under_the_profiler(dev, monkeypatch):
    """A capture and its replays while ``torch.profiler`` records (the
    benchmark's traced frames): the eager loop's results, and the replayed
    K2f / K2b kernels and the eager K1 in the trace, one an iteration."""
    scene = _scene(dev)
    tcfg = TrackingConfig(num_iters=40, early_stop_delta=0.0)
    want = _solve(monkeypatch, scene, tcfg, eager=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = _solve(monkeypatch, scene, tcfg)
    _assert_same_solve(got, want)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel in ("fused_track_kernel", "preprocess_fwd_kernel", "preprocess_bwd_kernel"):
        assert sum(kernel in n for n in names) == 40, kernel
