"""The port's spans and counters (``utils/trace.py``) on the CPU: the
tracer's own rules, every key of ``System.timings`` from construction on,
the parts of each layer against the layer over a few ORB-frontend frames,
the spans in a ``torch.profiler`` trace beside the ops they time, and no
``record_function`` without a profiler."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import (
    CameraConfig,
    MappingConfig,
    SystemConfig,
    TrackingConfig,
)
from gsorb_slam_tpu_torch.interop import system_config_from_dict
from gsorb_slam_tpu_torch.raster import RasterConfig
from gsorb_slam_tpu_torch.slam import dataset as D
from gsorb_slam_tpu_torch.slam import geometric as G
from gsorb_slam_tpu_torch.slam import system as S
from gsorb_slam_tpu_torch.utils import trace
from gsorb_slam_tpu_torch.utils.trace import Tracer

torch.set_num_threads(1)

W, H = 128, 96
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
MAP_PARTS = ("map.prune", "map.bins", "map.render", "map.densify", "map.window",
             "map.layouts", "map.iter", "map.wait")


def _render_system(track_iters: int = 10, map_iters: int = 4):
    """A tiny render-frontend System and its sequence (64x48)."""
    cam_cfg = CameraConfig(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0, fps=10)
    cfg = SystemConfig(
        camera=cam_cfg,
        mapping=MappingConfig(num_iters=map_iters, init_iters=5, max_gaussians=16384,
                              window_size=4, covis_window=2),
        tracking=TrackingConfig(num_iters=track_iters),
    )
    ds = D.SyntheticDataset(Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48),
                            n_frames=3, n_splats=600, seed=3, motion_scale=0.12, device="cpu")
    rcfg = RasterConfig(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=8.0)
    return S.System(cfg, max_keyframes=8, raster=rcfg, seed=0, device="cpu"), ds


@pytest.fixture(scope="module")
def orb_run():
    """Five frames of a distorted TUM-like sequence through the ORB System,
    loop closing on."""
    ds = D.TUMLikeDataset(n_frames=5, seed=0, width=W, height=H, apply_distortion=True,
                          splat_spacing=0.05, device="cpu")
    c = ds.cam
    cfg = system_config_from_dict({
        "Camera": {"width": W, "height": H, "fx": c.fx, "fy": c.fy, "cx": c.cx, "cy": c.cy,
                   "fps": 30.0, "k1": 0.262383, "k2": -0.953104, "p1": -0.005358,
                   "p2": 0.002628, "k3": 1.163314},
        "Mapping": {"numIters": 3, "maxGaussians": 65536},
        "Tracking": {"numIters": 6},
        "ORBextractor": {"nFeatures": 500},
        "Debug": {"useLoop": True},
    })
    # A short lost-mode budget: frames the ORB pose misses take 8 iterations.
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=5),
                      tracking=dataclasses.replace(cfg.tracking, lost_num_iters=8))
    s = S.System(cfg, seed=0, frontend="orb", device="cpu",
                 raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))
    for fr in ds:
        s.track_rgbd(torch.as_tensor(fr.rgb), torch.as_tensor(fr.depth), fr.timestamp)
    return s


def test_tracer_rules():
    """Names made at zero; a wait is charged to the innermost open layer and
    left out of the parts open inside it; counters add; with no tracer
    current the module functions only run the read."""
    tr = Tracer(("frame", "map", "map.bins", "map.wait"), ("added",))
    assert tr.totals == {"frame": 0.0, "n_frame": 0, "map": 0.0, "n_map": 0, "map.bins": 0.0,
                         "n_map.bins": 0, "map.wait": 0.0, "n_map.wait": 0, "added": 0}
    assert trace.active() is None
    assert trace.wait(int, torch.tensor(3)) == 3
    trace.count("added", 5)
    with trace.span("map"):
        pass
    assert tr.totals["added"] == 0 and tr.totals["n_map"] == 0

    def slow_read(x):
        t = torch.ones(300, 300)
        for _ in range(20):
            t = t @ t / 300.0
        return int(x)

    with tr.current():
        assert trace.active() is tr
        with trace.span("frame"):
            with trace.span("map"):
                with trace.span("map.bins"):
                    assert trace.wait(slow_read, torch.tensor(7)) == 7
            assert trace.wait(int, torch.tensor(1)) == 1
        trace.count("added", 5)
        trace.count("added", 2)
    assert trace.active() is None
    t = tr.totals
    assert t["n_map.wait"] == 1 and t["n_frame.wait"] == 1 and t["n_map.bins"] == 1
    assert t["added"] == 7
    # The wait lies inside map.bins but is left out of it, and kept in map.
    assert 0.0 <= t["map.bins"] < t["map.wait"]
    assert t["map.bins"] + t["map.wait"] <= t["map"] <= t["frame"]
    tr.clear()
    assert set(tr.totals.values()) == {0}


def test_timings_keys_from_construction_and_after_reset():
    s, ds = _render_system(track_iters=4, map_iters=2)
    names = S.SPANS + G.PHASES
    want = set(names) | {"n_" + n for n in names} | set(S.COUNTERS)
    assert set(s.timings) == want
    assert all(type(v) in (int, float) and v == 0 for v in s.timings.values())
    for i in range(2):
        s.track_rgbd(ds[i].rgb, ds[i].depth, float(i))
    assert s.timings["n_frame"] == 2 and s.timings["n_track"] == 1 and s.timings["n_map"] == 2
    s.reset()
    assert set(s.timings) == want
    assert all(isinstance(v, (int, float)) for v in s.timings.values())
    summary = s.shutdown_summary()
    assert {"phase_" + k for k in want} <= set(summary)
    assert summary["phase_n_frame"] == 2


def test_parts_within_layers(orb_run):
    s = orb_run
    t = s.timings
    n = len(s.trajectory)
    assert t["n_frame"] == n and t["n_track"] == n - 1 and t["n_map"] == n
    assert t["n_frontend"] == n and t["n_kf"] == sum(r.is_keyframe for r in s.trajectory)
    # Each layer holds its parts.
    assert t["track.bins"] + t["track.iter"] + t["track.wait"] <= t["track"]
    assert t["n_track.iter"] == sum(r.track_iters for r in s.trajectory) > 0
    assert t["n_track.bins"] >= t["n_track"]
    assert sum(t[k] for k in MAP_PARTS) <= t["map"]
    assert t["n_map.iter"] > 0 and t["n_map.wait"] > 0 and t["n_map.render"] == n - 1
    kf_parts = ("kf.pool", "kf.loop", "kf.wait") + tuple(
        p for p in G.PHASES if p.startswith("kf."))
    assert sum(t[k] for k in kf_parts) <= t["kf"]
    assert t["n_kf.pool"] == t["n_kf.loop"] == t["n_kf"] - 1  # frame 0's keyframe has neither
    assert t["fe.total"] + t["frontend.wait"] <= t["frontend"]
    assert t["n_fe.total"] == n - 1 and t["n_frontend.wait"] == n
    assert t["frontend"] + t["track"] + t["kf"] + t["map"] + t["frame.wait"] <= t["frame"]
    assert t["n_frame.wait"] == 2 * (n - 1)  # the FrameRecord's loss and iterations
    # The counters.
    assert t["splats_added"] == sum(s.densify_added)
    assert t["kf_bins_refreshed"] >= 1
    # The frontend's phases, read through its own view.
    assert set(s.fe.timings) <= set(G.PHASES)
    assert s.fe.timings["fe.total"] == t["fe.total"] > 0


def test_standalone_frontend_records_into_its_own_tracer():
    ds = D.TUMLikeDataset(n_frames=2, seed=0, width=W, height=H, apply_distortion=False,
                          splat_spacing=0.05, device="cpu")
    fe = G.GeometricFrontend(ds.cam, device="cpu")
    assert fe.timings == {} and set(fe.tracer.totals) == (
        set(G.PHASES) | {"n_" + p for p in G.PHASES})
    gray = lambda fr: torch.as_tensor(fr.rgb @ np.float32([0.299, 0.587, 0.114]))
    fe.create_keyframe(fe._extract(gray(ds[0])), ds[0].depth, ds[0].gt_T_cw, 0)
    fe.process_frame(gray(ds[1]), ds[1].gt_T_cw)
    assert fe.timings["fe.total"] >= fe.timings["fe.extract"] > 0
    assert fe.timings["kf.new_points"] > 0 and "kf.lba" not in fe.timings
    fe.tracer.clear()
    assert fe.timings == {}


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _inside(a, b):
    return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]


def test_spans_in_the_profiler_trace(tmp_path):
    """Under ``torch.profiler`` (CPU), the spans are ``user_annotation``
    events nested as their names say, one ``track.iter`` per iteration, and
    the ops of the tracking iterations fall inside their ``track.iter``."""
    s, ds = _render_system()
    s.track_rgbd(ds[0].rgb, ds[0].depth, 0.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in (1, 2):
            s.track_rgbd(ds[i].rgb, ds[i].depth, float(i))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ev = _events(path)
    spans = [e for e in ev if e.get("cat") == "user_annotation"]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    assert {"frame", "track", "track.bins", "track.iter", "map", "map.iter", "map.wait",
            "track.wait"} <= set(by)
    assert len(by["frame"]) == 2 and len(by["track"]) == 2
    assert len(by["track.iter"]) == sum(r.track_iters for r in s.trajectory[1:]) > 0
    assert len(by["map.iter"]) == 2 * s.cfg.mapping.num_iters

    def parent(e, name):
        return [p for p in by[name] if _inside(e, p)]

    for name, outer in (("track", "frame"), ("map", "frame"), ("track.iter", "track"),
                        ("track.bins", "track"), ("map.iter", "map"), ("map.bins", "map")):
        assert all(len(parent(e, outer)) == 1 for e in by[name]), (name, outer)
    for e in by["track.wait"]:
        assert parent(e, "track")
    for e in by["map.wait"]:
        assert parent(e, "map")
    # The ops issued between a frame's first and last iteration lie inside
    # some track.iter, or a rebinning episode's track.bins (the early-stop
    # read is a track.wait inside its iteration).
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    for tr in by["track"]:
        iters = [e for e in by["track.iter"] if _inside(e, tr)]
        lo = min(e["ts"] for e in iters)
        hi = max(e["ts"] + e["dur"] for e in iters)
        rebins = [e for e in by["track.bins"] if _inside(e, tr)]
        inner = [o for o in ops if lo <= o["ts"] < hi
                 and not any(_inside(o, b) for b in rebins)]
        assert inner
        assert all(any(_inside(o, it) for it in iters) for o in inner)
        assert all(any(_inside(it, p) for p in iters) for it in by["track.wait"]
                   if _inside(it, tr) and lo <= it["ts"] < hi)


def test_no_profiler_no_record_function(monkeypatch):
    """With ``record_function`` raising, frames run without a profiler, and
    a profiled frame reaches it (the patch is the one the tracer calls)."""
    s, ds = _render_system(track_iters=3, map_iters=2)

    def boom(*a, **kw):
        raise RuntimeError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    for i in range(2):
        s.track_rgbd(ds[i].rgb, ds[i].depth, float(i))
    assert s.timings["n_track.iter"] == s.trajectory[1].track_iters
    with pytest.raises(RuntimeError, match="without a profiler"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            s.track_rgbd(ds[2].rgb, ds[2].depth, 2.0)
