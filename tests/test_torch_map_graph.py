"""The mapping iteration's CUDA graphs (``slam/map_graph.py``) against the
eager loop, on the card.

Marked ``cuda``: without a CUDA device every test skips. This file imports
neither jax nor the JAX package: ``python -m pytest --noconftest -m cuda
tests/test_torch_map_graph.py``. ``map_window`` on CUDA tensors replays
the graphs; ``map_step`` over a list of layouts is the eager loop. The two
run the same kernels in the same order with no float atomics, so the map's
rows, Adam's moments and step and every iteration's loss agree bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import MappingConfig
from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess, render
from gsorb_slam_tpu_torch.slam import mapping as M
from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES, empty_map
from gsorb_slam_tpu_torch.utils import cuda_graphs as CG
from gsorb_slam_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

CAM = Camera(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)
RCFG = RasterConfig(tile=16, tile_capacity=512, max_dup=16, chunk=128, dilate_px=2.0,
                    exact_stop=False)
MCFG = MappingConfig()
DRAWS = [0, 2, 1, 1, 0, 2, 2, 0, 1, 0, 2, 1]
COUNTERS = ("map_graph_captures", "map_graph_replays", "map_prep_kernels", "map_ssim_kernels")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    CG._GRAPHS.clear()
    yield torch.device("cuda")
    CG._GRAPHS.clear()


def _window(dev, n=3000, capacity=4096):
    """A map of ``n`` live splats (perturbed in colour and opacity) and a
    3-frame window rendered from the unperturbed map, each frame binned
    from the perturbed map at its pose."""
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
    pert = dataclasses.replace(
        gm, rgb=torch.clamp(gm.rgb + f32(rng.normal(0, 0.1, (capacity, 3))), 0.0, 1.0),
        logit_opacities=gm.logit_opacities + f32(rng.normal(0, 0.5, capacity)))
    poses = [torch.eye(4, device=dev),
             pose_to_matrix(f32([1.0, 0.01, -0.01, 0.005]), f32([0.02, -0.01, 0.0])),
             pose_to_matrix(f32([1.0, -0.01, 0.0, 0.01]), f32([-0.02, 0.0, 0.01]))]
    params = lambda m: (m.means, m.rgb, m.quats, m.logit_opacities, m.log_scales, m.active)
    with torch.no_grad():
        gts = [render(*params(gm), P, CAM, RCFG) for P in poses]
        bins = [bin_gaussians(preprocess(*params(pert), P, CAM), CAM, RCFG) for P in poses]
    frames = M.build_window_frames(
        [o.color for o in gts], [torch.where(o.alpha > 0.5, o.median_depth, 0.0) for o in gts],
        poses, bins, 3, 3, device=dev)
    return pert, frames


def _eager(gm, frames, draws, budget, init_mode=False):
    """The eager loop: ``map_step`` over the window's list of layouts."""
    layouts = M.window_layouts(frames, gm.capacity, CAM, RCFG, budget)
    losses = []
    for k in draws:
        gm, loss = M.map_step(gm, frames, k, layouts, CAM, MCFG, RCFG, init_mode)
        losses.append(loss)
    return gm, torch.stack(losses)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same_bits(a, b, losses_a, losses_b):
    for n in PARAM_NAMES:
        assert torch.equal(_bits(getattr(a, n)), _bits(getattr(b, n))), n
        assert torch.equal(_bits(a.adam_m[n]), _bits(b.adam_m[n])), "m " + n
        assert torch.equal(_bits(a.adam_v[n]), _bits(b.adam_v[n])), "v " + n
    assert torch.equal(a.adam_t, b.adam_t)
    assert torch.equal(_bits(losses_a), _bits(losses_b))


def test_map_window_graph_matches_eager_loop(dev):
    """Graph replays against the eager loop, bit for bit: a first call
    (one eager iteration, the capture, 11 replays), a second call on the
    same shapes (12 replays), a call with another chunk budget (a new
    capture) and an ``init_mode`` call (its own graph). Counters and K4 /
    K5 / K10f / K10b / K11f / K11b launches count each iteration once."""
    gm, frames = _window(dev)
    budget = M.window_chunk_budget(frames.bins_counts, RCFG.chunk)
    tracer = trace.Tracer(counters=COUNTERS)
    calls = [(budget, False, 1, 11), (budget, False, 1, 23), (budget + 1024, False, 2, 34),
             (budget, True, 3, 45)]
    with torch.no_grad(), tracer.current():
        for b, init_mode, captures, replays in calls:
            want_gm, want_losses = _eager(gm, frames, DRAWS, b, init_mode)
            _build.reset_launches()
            got_gm, got_losses = M.map_window(gm, frames, DRAWS, CAM, MCFG, RCFG,
                                              init_mode=init_mode, chunk_budget=b)
            assert _build.launches["blend_flat_fwd"] == len(DRAWS)
            assert _build.launches["blend_flat_bwd"] == len(DRAWS)
            assert _build.launches["map_attr_fwd"] == len(DRAWS)
            assert _build.launches["map_attr_bwd"] == len(DRAWS)
            assert _build.launches["ssim_fwd"] == len(DRAWS)
            assert _build.launches["ssim_bwd"] == len(DRAWS)
            _assert_same_bits(got_gm, want_gm, got_losses, want_losses)
            assert int(got_gm.adam_t) == len(DRAWS)
            assert tracer.totals["map_graph_captures"] == captures
            assert tracer.totals["map_graph_replays"] == replays
            assert tracer.totals["map_prep_kernels"] == replays + captures
            assert tracer.totals["map_ssim_kernels"] == replays + captures
    assert sorted((o, f) for o, _, f in CG._GRAPHS) == [("map", False), ("map", True)]


def test_map_window_graph_keeps_the_call_contract(dev, monkeypatch):
    """``map_loss_and_grads`` is entered once per iteration with the map's
    current state, and returns that iteration's loss and gradients (what
    the benchmark's check clones); a patched ``adam_step`` is what the
    graph steps with: a counting one runs at the eager iteration and the
    capture and gives the eager loop's map, one that returns its map leaves
    the map as it was."""
    gm, frames = _window(dev)
    budget = M.window_chunk_budget(frames.bins_counts, RCFG.chunk)
    seen = []
    orig_grads = M.map_loss_and_grads

    def recording(g, fr, k, layout, cam, mcfg, rcfg, init_mode=False):
        state = {n: getattr(g, n).clone() for n in PARAM_NAMES}
        loss, grads = orig_grads(g, fr, k, layout, cam, mcfg, rcfg, init_mode)
        seen.append((state, loss.clone(), {n: v.clone() for n, v in grads.items()}))
        return loss, grads

    with torch.no_grad():
        want = []
        layouts = M.window_layouts(frames, gm.capacity, CAM, RCFG, budget)
        g = gm
        for k in DRAWS:
            state = {n: getattr(g, n).clone() for n in PARAM_NAMES}
            loss, grads = M.map_loss_and_grads(g, frames, k, layouts[k], CAM, MCFG, RCFG)
            want.append((state, loss, grads))
            g = M.adam_step(g, grads, M.map_learning_rates(MCFG))
        want_gm = g

        monkeypatch.setattr(M, "map_loss_and_grads", recording)
        steps = []
        orig_step = M.adam_step
        monkeypatch.setattr(M, "adam_step", lambda *a: steps.append(1) or orig_step(*a))
        for call in range(2):
            seen.clear()
            got_gm, _ = M.map_window(gm, frames, DRAWS, CAM, MCFG, RCFG, chunk_budget=budget)
            assert len(seen) == len(DRAWS)
            for (s_got, l_got, g_got), (s_want, l_want, g_want) in zip(seen, want):
                for n in PARAM_NAMES:
                    assert torch.equal(_bits(s_got[n]), _bits(s_want[n])), n
                    assert torch.equal(g_got[n], g_want[n]), n
                assert torch.equal(_bits(l_got), _bits(l_want))
            for n in PARAM_NAMES:
                assert torch.equal(_bits(getattr(got_gm, n)), _bits(getattr(want_gm, n))), n
            assert len(steps) == 2  # the eager iteration and the capture, then replays

        monkeypatch.setattr(M, "adam_step", lambda g, grads, lrs: g)
        same_gm, _ = M.map_window(gm, frames, DRAWS, CAM, MCFG, RCFG, chunk_budget=budget)
        for n in PARAM_NAMES:
            assert torch.equal(getattr(same_gm, n), getattr(gm, n)), n
        assert torch.equal(same_gm.adam_t, gm.adam_t)


def test_map_window_graph_captures_under_the_profiler(dev):
    """A capture and its replays while ``torch.profiler`` records (the
    benchmark's traced frames): the eager loop's results, and the replayed
    K4 / K5 kernels in the trace."""
    gm, frames = _window(dev)
    budget = M.window_chunk_budget(frames.bins_counts, RCFG.chunk)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        want_gm, want_losses = _eager(gm, frames, DRAWS, budget)
        with torch.profiler.profile(activities=acts) as prof:
            got_gm, got_losses = M.map_window(gm, frames, DRAWS, CAM, MCFG, RCFG,
                                              chunk_budget=budget)
            torch.cuda.synchronize()
    _assert_same_bits(got_gm, want_gm, got_losses, want_losses)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("blend_flat_fwd" in n for n in names) == len(DRAWS)
