"""One run of one cell (``slambench/run.py`` calls :func:`run_cell` once it
has found the card; the harness tests call it on the CPU at a tiny size).

A frame goes through the entry point of the configuration's sensor:
``System.track_rgbd(colour, depth)`` (tensors on the device), or on a
stereo configuration ``System.track_stereo(left, right)`` (float32 numpy
in [0, 1], as ``KittiStereoDataset`` hands them). ``psnr_db`` compares
against the (left) colour on the pixels with a true depth.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from slambench.lib import catalog
from slambench.lib import correctness as C
from slambench.lib import roofline
from slambench.lib.capture import Hooks, clone_rows
from slambench.lib.evaluate import ate_rmse
from slambench.lib.scene import load_scene
from slambench.lib.sequence import (
    camera_from_config,
    frame_tensors,
    make_sequence,
    sensor_of,
    stereo_pair,
)
from slambench.lib.trace import summarize, trace_file
from slambench.reference import render as R

FORBIDDEN = ("jax", "jaxlib", "flax", "gsorb_slam_tpu")
SPLIT = ("frontend", "kf", "track", "map")  # the System's timers, logged per frame
RASTER_FIELDS = ("tile", "tile_capacity", "track_tile_capacity", "max_dup", "chunk",
                 "dilate_px", "exact_stop")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load
    (compared whole: ``gsorb_slam_tpu_torch`` is not ``gsorb_slam_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_raster(system, cfg: dict) -> None:
    """The run departs from nothing the configuration states: the System's
    tiling is the configuration's."""
    want = cfg["raster"]
    got = {f: getattr(system.rcfg, f) for f in RASTER_FIELDS}
    got["track_tile_capacity"] = system.rcfg_t.tile_capacity
    bad = {f: (got[f], want[f]) for f in RASTER_FIELDS if got[f] != want[f]}
    if bad:
        raise SystemExit(f"the System's raster config departs from the configuration: {bad}")


def _psnr(snapshot: dict, seq, poses: list[np.ndarray], frames: range, st: C.Setting,
          device: torch.device) -> float:
    """Mean PSNR over ``frames`` of the reference's render of the map
    snapshot at the tracked poses against the (left) colour, on the pixels
    with a true depth reading."""
    s = C.splats(snapshot)
    vals = []
    with torch.no_grad():
        for i in frames:
            color, depth = frame_tensors(seq, i, device)
            T = torch.as_tensor(np.asarray(poses[i], np.float32), device=device)
            out = R.render(s, T, st.cam, st.render_tiling, st.scale_modifier)
            vals.append(R.psnr(out["color"], color, depth > 0))
    return float(np.mean(vals))


def _rooflines(hooks: Hooks, st: C.Setting, n_pixels: int) -> dict:
    """Least seconds of the profiled frames' tracking iterations and
    mapping iterations (``slambench.lib.roofline``), from the map rows and
    poses captured on those frames."""
    least_track = 0.0
    for rec in hooks.track_solves:
        s = C.splats(rec["rows"])
        pairs, inst = R.pairs_to_last(s, rec["T_best"], st.cam, st.track_tiling, crossing=True,
                                      scale_modifier=st.scale_modifier)
        n_rows = int(rec["rows"]["active"].sum())
        least_track += int(rec["n_iters"]) * roofline.iteration_least_s(
            pairs, inst, n_rows, n_pixels, write_rows=False)
    least_map = 0.0
    for rec in hooks.map_windows:
        s = C.splats(rec["rows"])
        n_rows = int(rec["rows"]["active"].sum())
        for k in sorted(set(int(x) for x in rec["frame_ids"])):
            uses = sum(1 for x in rec["frame_ids"] if int(x) == k)
            pairs, inst = R.pairs_to_last(s, rec["poses"][k], st.cam, st.render_tiling,
                                          crossing=False, scale_modifier=st.scale_modifier)
            least_map += uses * roofline.iteration_least_s(pairs, inst, n_rows, n_pixels,
                                                           write_rows=True)
    return {"track_least_s": least_track if hooks.track_solves else None,
            "map_least_s": least_map if hooks.map_windows else None}


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, control: bool = False, t_process: float | None = None
             ) -> dict:
    t_process = time.perf_counter() if t_process is None else t_process
    bench = catalog.load_benchmark(root)
    cell = catalog.workload(bench, cell_name)
    cfg = catalog.config(root, cell["config"])
    traffic = catalog.traffic(root, cell["traffic"])
    limits = catalog.limits(root, cell_name)
    sensor = sensor_of(cfg)
    st = C.setting_from_config(cfg)
    rng = np.random.default_rng(seed)
    warm = int(traffic["warmup_frames"])
    n_eval = int(traffic["eval_frames"])
    n_frames = int(traffic["n_frames"])

    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.slam.system import System

    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        _build.library()  # the kernel library: built once per checkout, then loaded
    marks.append(("library", time.perf_counter()))

    # Inputs: the scene, the path and the sensor, from the seed.
    cam = camera_from_config(cfg["system"])
    seq = make_sequence(load_scene(catalog.scene_path(root, traffic["scene"])), cam, traffic,
                        seed, device, sensor)
    log(f"sequence: {sensor}, {n_frames} frames {cam.width}x{cam.height}, "
        f"depth zero share {float((seq.depths == 0).mean()):.4f}")

    marks.append(("sequence", time.perf_counter()))
    hooks = Hooks(rng)
    hooks.install()
    system = System(cfg["system"], frontend=cfg["frontend"], seed=seed, device=device)
    _check_raster(system, cfg)
    marks.append(("system", time.perf_counter()))
    sample = int(rng.integers(warm, n_eval))  # the frame the check reads
    poses: list[np.ndarray] = []
    splits: list[tuple] = []  # per frame: ms of the whole call and of each System timer

    def step(i: int) -> float:
        if i >= n_frames:
            raise SystemExit(f"the run ran out of frames at {i}: raise n_frames in "
                             f"slambench/traffic/{cell['traffic']}.json (a benchmark PR)")
        if i == sample:
            hooks.fe_armed = True
            hooks.track_armed = True
            hooks.render_armed = True
            hooks.map_armed = True
        before = {k: system.timings.get(k, 0.0) for k in SPLIT + ("n_kf",)}
        t0 = time.perf_counter()
        if sensor == "stereo":
            left, right = stereo_pair(seq, i)
            T = system.track_stereo(left, right, timestamp=float(seq.timestamps[i]))
        else:
            color, depth = frame_tensors(seq, i, device)
            T = system.track_rgbd(color, depth, timestamp=float(seq.timestamps[i]))
        t1 = time.perf_counter()
        poses.append(np.asarray(T, np.float64))
        splits.append((i, 1000.0 * (t1 - t0)) + tuple(
            1000.0 * (system.timings.get(k, 0.0) - before[k]) for k in SPLIT)
            + (int(system.timings.get("n_kf", 0) - before["n_kf"]),))
        return t1 - t0

    for i in range(warm):
        step(i)
    _sync(device)
    timings0 = dict(system.timings)
    splats0 = int(system.gm.n_active())
    gc.collect()
    gc.freeze()
    t_win = time.perf_counter()
    setup_s = t_win - t_process
    marks.append(("warm-up frames", t_win))

    # The measured window: whole frames until the mark; the frame that
    # crosses it is finished and counted.
    frame_s: list[float] = []
    snapshot = None
    i = warm
    while True:
        frame_s.append(step(i))
        i += 1
        if i == n_eval:
            snapshot = clone_rows(system.gm)
        if time.perf_counter() - t_win >= seconds:
            break
    t_end = time.perf_counter()
    splats1 = int(system.gm.n_active())
    log("setup (s): " + " ".join(f"{name} {t - t0:.3f}" for (name, t), (_, t0) in
                                 zip(marks, [("start", t_process)] + marks[:-1])))
    window = dict(frames=len(frame_s), seconds=t_end - t_win, frame_s=frame_s,
                  timings={k: system.timings[k] - timings0.get(k, 0) for k in timings0},
                  track_iters=[r.track_iters for r in system.trajectory[warm:i]])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # Untimed: the eval prefix, and a mapping iteration for the check.
    while i < n_eval or ((hooks.map_armed or hooks.fe_armed) and i < n_eval + 10):
        step(i)
        i += 1
        if i == n_eval:
            snapshot = clone_rows(system.gm)

    summary = None
    if trace:
        summary = _traced_frames(system, hooks, step, i, int(traffic["profiled_frames"]))
        i += int(traffic["profiled_frames"])
    if device.type == "cuda":
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    hooks.remove()
    ate_mm = 1000.0 * ate_rmse(np.stack(poses[:n_eval]), seq.T_cw[:n_eval])
    n_pixels = cam.width * cam.height
    T_sample = poses[sample]
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    lc = getattr(system, "loop_closer", None)
    log(f"loop closing: last closed at keyframe {lc.last_closed_kf if lc else None} "
        f"({len(system.keyframes)} keyframes)")
    del system
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # After the window: PSNR and the check, with the reference.
    psnr_db = _psnr(snapshot, seq, poses, range(n_eval), st, device)
    nums = C.evaluate(hooks, T_sample, st)
    log("check numbers: " + " ".join(f"{k}={v!r}" for k, v in nums.items()))
    correct, checks = C.judge(nums, limits)
    ctl_result = None
    if control:
        ctl = C.evaluate(hooks, T_sample, st, control=True)
        log("control numbers: " + " ".join(f"{k}={v!r}" for k, v in ctl.items()))
        ctl_ok, ctl_checks = C.judge(ctl, limits)
        ctl_result = {"correct": bool(ctl_ok), "checks": ctl_checks}
        log(f"control: correct={ctl_ok} " + " ".join(
            f"{k}={c['value']!r} (limit {c['limit']!r})" for k, c in ctl_checks.items()))

    ctx = dict(window=window, setup_s=setup_s, psnr_db=psnr_db, trace=summary,
               roofline=_rooflines(hooks, st, n_pixels) if trace else {})
    log("frames (i, ms: call " + " ".join(SPLIT) + ", keyframes): " + " ".join(
        "(%d %.0f %.0f %.0f %.0f %.0f %d)" % x for x in splits[warm:warm + window["frames"]]))
    log(f"window: {window['frames']} frames in {window['seconds']:.3f} s; sampled frame "
        f"{sample}; ate_mm={ate_mm!r} psnr_db={psnr_db!r}; frames run {i}; active splats "
        f"{splats0} at the window's start, {splats1} at its end")
    metrics = {}
    for m in catalog.cell_metrics(bench, cell_name, trace):
        v = catalog.metric_reader(root, m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": window["frames"],
        "failed": sum(1 for p in poses if not np.isfinite(p).all()),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": device_name,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    if ctl_result is not None:
        result["control"] = ctl_result
    result["checks"] = checks
    return result


def _traced_frames(system, hooks: Hooks, step, i0: int, n: int):
    """Profile ``n`` whole frames from frame ``i0``; returns the trace's
    summary (``slambench.lib.trace``)."""
    dev = system.device
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    hooks.trace_ranges = True
    hooks.profiling = True
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(n):
            with torch.profiler.record_function("slambench.frame"):
                step(i0 + k)
        _sync(dev)
    hooks.trace_ranges = False
    hooks.profiling = False
    path = trace_file()
    try:
        prof.export_chrome_trace(path)
        del prof
        return summarize(path)
    finally:
        os.remove(path)
