#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``gsorb_slam_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
The first run builds the CUDA kernels into ``build/kernels/``.

Workload: ``bench.py``'s tracking and mapping workloads — TUM1's camera at
640x480, a 2^18-slot map holding 250,000 random splats made from
``np.random.default_rng(0)``, the production raster views (tile 16,
tracking capacity 512, render and mapping capacity 2048, chunk 256,
max_dup 16, dilate 2 px, fast stop), ``TrackingConfig(num_iters=200,
early_stop_delta=0)`` with rebins at (8, 40, 120), and ``MappingConfig()``
(100 mapping iterations).

Phases (any failed check makes the exit code non-zero):
1. the card's name and power limit; the kernel build;
2. K3 (forward blend) against its plain version at render capacity 2048
   under both stop rules: rows, chunk_t, the last applied slots, and its
   visit words (K6's residual) equal to the plain version's, every visited
   slot kept by the plain version of its footprint cull;
3. K2f / K2b (instance projection and its pose adjoint) against their plain
   versions on the tracking pack at a pose 1 cm off; K2b (after phase 4,
   on K1's gradients) also in one launch (the wrapper's count and
   torch.profiler's), bit for bit on a rerun, and on the adjoint's
   edge-case pack (``adjoint_edge_pack``: near plane, clips, det <= 0,
   dead slots, zero cotangents) at T = 7 x cap 300, one tile of one and of
   two blocks, and T = 0;
4. K1 (fused tracking iteration) against its plain version: loss,
   per-instance gradients, and the pose gradient through K2b; then K1 on
   the pack padded with dead slots to capacity 2048, bit for bit;
5. the main path: render the gt with ``render_binned`` (K3) at the identity
   pose, ``track_frame`` from bench.py's initial pose, then ``render`` the
   view at the tracked pose (K3); the final pose error must fall below 10%
   of the initial one, the tracked view must beat the initial pose's view
   by 6 dB PSNR against the gt, and every kernel of the path must have
   launched (K1 = K2f = K2b = 200, K3 >= 1);
6. timings: ms per tracking iteration over 10 more frames (best and
   quartiles; each frame must reproduce the main path's pose bit for bit),
   a profiled frame (its device launches per iteration), and each kernel's
   time by CUDA events beside its plain version's and its bound (the work
   this run's data needs);
7. K4 / K5 (the flat-chunk mapping blend and its backward) against their
   plain versions on the render bins laid out by ``chunk_layout`` with the
   System's chunk budget: K4's rows under both stop rules and its visit
   words equal to the plain version's, every visited slot kept by the
   plain version of K4's footprint cull, K5's ten gradient rows under a
   seeded random cotangent, and the parameter gradients through the pack
   and ``preprocess``;
8. the mapping step: a window of 4 frames (gt = K3 renders of the map at the
   identity pose and 3 poses 2 cm / 2 degrees away) against a perturbed map;
   at the identity frame ``prune_map``, a K3 render, ``densify_frame`` and
   a rebin, then ``map_window`` (100 iterations through K4 / K5) and
   ``prefix_writeback``. K3 = 1 and K4 = K5 = 100 launches; finite
   outputs; the last 10 losses below the first 10; the window's mean PSNR
   up by at least 1 dB; a second run bitwise equal;
9. timings: ms per mapping iteration over 5 more calls (each bitwise equal
   to the main path's map), a profiled call, and K4 / K5 by CUDA events
   beside their plain versions and bounds;
10. K7 (the exact-stop fused tracking iteration) against its plain version on
    phase 4's tracking pack: loss, per-instance gradients with the loss-edge
    pixels left out, and the pose gradient through K2b;
11. K8 (the paired-rect fused tracking iteration) against its plain version
    (K1's over the rect tiles, un-paired) on the System's paired tracking view
    (16x8 tiles, capacity 512, chunk 256) binned at phase 4's pose with the
    count-sorted pairing: the same checks, and K8 at capacity 2048 as in
    phase 4;
12. the RGB-D System: ``track_rgbd`` over the first 10 frames of a TUM-like
    sequence generated on the card (VGA, TUM1's intrinsics, no distortion,
    Kinect noise; 100 frames long, so each frame moves as far as a TUM fr1
    frame), TUM1's configuration (a dict: no PyYAML) and
    ``System.default_raster_config(640)``, then ``evaluate_sequence``: poses
    finite, ATE < 2 cm, PSNR >= 18 dB, launches K1 = K2f = K2b = the tracking
    iterations, K4 = K5 = init + 9 x 100 mapping iterations, K3 = 9 within
    ``track_rgbd`` (one densify render per tracked frame) and 19 with the
    evaluation's renders, K7 = K8 = 0; frame times, and one more frame profiled; a second System
    over the first 4 frames bitwise equal;
13. the System with ``exact_stop=True`` and with ``paired=True`` over the
    first 4 frames: ATE < 2 cm, K7 (K8) = the tracking iterations, K1 = 0;
14. K6 (the per-tile blend backward) against its plain version on phase 2's
    render bins under both stop rules, with K3's residuals (visit words
    included): a seeded random cotangent on rows 0-4 and the final T with
    the gate-edge pixels left out, written over a NaN-filled block, two
    launches bitwise equal, and the render's parameter gradients through the pack and
    ``preprocess`` (background 0.3) against the plain chain;
15. the window-sharded mapping on a one-rank NCCL process group (from a
    ``FileStore`` in a temporary directory: no network): phase 8's map after
    its prune and densify, its 4-frame window, 100 ``parallel_window_step``
    steps rotating over the frames. K3 = K6 = 100, K4 = K5 = 0, 100
    ``all_reduce`` calls, loss down, window PSNR up by at least 1 dB, three
    more calls bitwise equal (timed), one profiled; one frame's pack slot
    table timed alone (the loop builds one per window frame);
16. the tile-sharded tracking at world size 1: ``parallel_track_frame`` from
    phase 5's initial pose over 200 iterations (K1 = K2f = K2b = 200) within
    1e-5 of phase 5's pose, and K1 over the two strided halves of
    ``strided_tile_perm(n_tiles, 2)`` against one unsharded launch (per-tile
    loss and gradient rows bit for bit, summed loss within 1e-6);
17. K9 (the ablation copy of K1: K1's iteration over exactly 2 chunks per
    tile, no stop, parts switchable) against its plain version on phase 4's
    tracking pack: the ``full`` variant's loss (1e-3 relative) and gradient
    rows with the loss-edge pixels of the no-stop blend left out (8e-4 +
    2e-3 |p|), two launches bitwise equal, ``fwd``'s per-tile loss rows
    bitwise equal to ``full``'s, every variant launched and finite; then K9's
    main path, ``profiling.profile_fused_ablate``'s ``main`` at the bench
    tracking view (every variant, K1 beside them);
18. the profilers by their ``main`` at the bench scene's width, each cut for
    time: ``profile_track`` (50 iterations, 1 timed frame per variant),
    ``profile_map_full`` (20 mapping iterations per variant, 1 timed call),
    ``profile_map_iter``, ``profile_raster``, ``profile_fused``,
    ``profile_paired_parts``, ``profile_gather`` (their defaults) and
    ``profile_mapping_quality`` (2 QVGA frames per ablation, ``base`` and
    ``freshbins``); each must return finite numbers, and each prints its
    lines;
19. the disk path on phase 12's sequence: its first 5 frames written in the
    TUM layout (``export_tum_format``: 8-bit rgb PNG, 16-bit depth PNG,
    jittered timestamps, ``groundtruth.txt``) and read back through
    ``open_dataset("tum", ...)``: 5 pairs associated, rgb equal to its
    8-bit export (within one quantum of the generated frame), depth within
    1.5 / 5000 m where valid, poses within 1e-5, the image codec (cv2, else
    Pillow) and its read time per frame;
    ``apps.run_rgbd.main`` over the directory with TUM1 as a ``.json``
    file (``--type tum --max-frames 5 --eval-stride 1``): exit code 0, ATE
    < 2 cm and PSNR >= 18 dB from its ``result.txt``, K1 = K2f = K2b = the
    tracking iterations, K4 = K5 = the mapping iterations, K3 = 9, the
    trajectory and the PLY written; ``apps.eval_ate`` on the two trajectory
    files within 1e-5 m of ``result.txt``'s ATE; ``apps.replay`` of the PLY
    along the trajectory (``--stride 1``): PSNR >= 18 dB, K3 = 5; 2 frames
    round-tripped through the Replica and ScanNet layouts (JPEG color); ``apps.run_benchmark.main`` once with
    ``--frontend render --no-distortion --frames 3`` (finite results, no
    instance dropped at the oracle capacity);
20. the render path's leftovers on phase 12's first 3 frames: a System with
    ``initScalarMethod`` 0 with frame 1 inside ``start_trace`` /
    ``stop_trace`` (the trace names K1's and K4's kernels), then
    ``reset()`` (frame_id 0, no keyframes, an empty map and trajectory,
    velocity I) and the 3 frames again (finite poses, ATE < 2 cm, launch
    counts); a System with ``initScalarMethod`` 1 (ATE < 2 cm); the
    Morton-window 3-NN on the card against the CPU on frame 0's candidates
    (1e-6 relative, equal Morton codes); the exact 3-NN's host time per
    densify;
21. the ORB frontend's modules on the card against the CPU (no kernel is
    involved) on a VGA TUM-like sequence with TUM1's distortion warped in:
    the frontend pins full f32 (TF32 off); ``extract_orb``'s keypoints
    equal and its descriptors bit for bit on at least 99% of the valid
    rows; ``hamming_matrix`` exact; ``pose_optimization`` and a 6-keyframe
    ``local_bundle_adjustment`` (their inputs taken from the frontend run
    over the first 6 frames at the ground-truth poses) within 1e-4, with
    equal inlier masks, and two card runs of the local BA bitwise equal
    (no atomics); wall times of the extraction, the Hamming matrix,
    ``search_by_projection``, the pose optimization and the local BA;
22. ``System(frontend="orb")`` with TUM1 (its distortion, ``useLoop`` on,
    the packaged vocabulary) over the distorted sequence's first 6 frames:
    ATE < 2 cm, PSNR >= 18 dB, launches K1 = K2f = K2b = the tracking
    iterations, K4 = K5 = init + 5 x 100, K3 = 5, K7 = K8 = 0; a 4-frame
    rerun bitwise equal (poses, splat map, map points); the median frame
    split into ``frontend``, ``kf``, ``track`` and ``map``, and
    ``GeometricFrontend.timings`` per phase;
23. loop closing on ``tests/test_loop_e2e.py``'s scene (96x72, 16 frames,
    poses injected under accumulating drift): the loop fires and the late
    keyframes end closer to the ground truth than 0.7x the injected drift;
    the closure's time (``verify`` + ``correct`` + fuse + global BA);
24. ``System(frontend="orb").track_stereo`` with TUM1 (distortion zero: the
    pairs are rectified; ``useLoop`` on) over the first 6 of 30 rectified VGA
    pairs of one generated scene (20,000 splats, baseline bf / fx = 7.73
    cm): stereo matches on every frame, launches K1 = K2f = K2b = the
    tracking iterations, K4 = K5 = 200 + 5 x 100, K3 = 5, K7 = K8 = 0; ATE <
    5 cm and PSNR >= 18 dB against the left views and the SGBM depth; the
    median frame split into ``frontend``, ``kf``, ``track``, ``map`` and the
    rest (SGBM, extraction, row matching); a 4-frame rerun bitwise equal;
25. ``System(frontend="orb").track_monocular`` with TUM1's camera and ORB
    settings and the JAX app's bootstrap gates (40 / 30) over the VGA
    version of ``configs/synthetic_mono.yaml``'s scene (12 frames): the
    bootstrap, a pose on every later frame, map points and splats; LOST
    after 2 blank frames, relocalized after a jump back to the first frames
    after the bootstrap; a short run lost with a young map resets itself
    and bootstraps again; no kernel launched over the phase; a rerun
    bitwise equal; the frame times;
26. ``compute_stereo_matches`` on phase 24's last VGA pair and
    ``initialize_monocular`` on phase 25's bootstrap, on the card against
    the CPU (stereo matches equal; the same model and inlier mask, T_cw2
    within 1e-4, two card runs bitwise equal), their wall times and SGBM's;
27. ``apps.run_stereo --type kitti`` over a KITTI layout written from phase
    24's first 3 pairs, ``apps.run_mono --type tum`` over phase 19's TUM
    directory and ``apps.run_mono --type synthetic`` with
    ``configs/synthetic_mono.yaml`` (as ``.json``, 8 frames): exit 0, both
    trajectory files and ``result.txt`` with ``frames_total``.
28. ``apps.viewer`` over phase 19's PLY (the System's map at TUM1's VGA
    camera): ``--mode orbit --frames 10`` and ``--mode replay`` along phase
    19's trajectory: exit 0, one PNG and one K3 launch per frame, the
    orbit's frame 0 equal to the 8-bit K3 render of its pose and K3 against
    the plain blend there (2e-3 on colour), ms per frame;
29. ``apps.viewer_web``: ``ViewerServer.from_system`` over phase 19's System
    on 127.0.0.1 at an ephemeral port: the page and the state, 5 ``splat``
    and one ``map`` request whose JPEGs decode at 640x480, one K3 launch per
    splat request, ms per request;
30. ``graft_entry.entry()`` (320x240, 20,000 splats): ``(loss, color)``
    through K3 against the same fn with the plain blend (colour 2e-3
    absolute, loss 1e-3 relative), two calls bitwise, a backward through K6
    with finite gradients, the forward's and the backward's ms;
31. ``graft_entry.dryrun_multichip(torch.cuda.device_count())``: one rank a
    card in an NCCL group (spawned processes): finite losses and pose, the
    ranks equal, 4 ``all_reduce`` calls, K3 = K6 = 1 and K1 = K2f = K2b = 3
    launches on each rank; the losses and pose against the same dry run on
    the CPU (gloo, the plain versions) within 1e-4;
32. LPIPS with seeded random weights in a temporary ``.npz`` on phase 19's
    render of the first frame and its gt at VGA: the card against the CPU
    (1e-4 relative), identical images below 1e-6, ``metrics.lpips``
    through ``GSORB_LPIPS_WEIGHTS``, TF32 off, ms per pair;
33. ``scripts.train_vocab`` on the card into a temporary ``--out``: the
    round-trip load, the word count, the share of node descriptors equal to
    the packaged vocabulary's (recorded), seconds;
34. ``scripts.debug_loop``'s ``main`` on the card: exit 0, verify's
    diagnostics, and the loop fires with phase 23's events;
35. ``scripts.make_tum_disk`` (3 TUM-like VGA frames generated on the card,
    the TUM and ScanNet layouts) read back through ``slam.dataset``, and
    ``scripts.pose2traj`` on the ScanNet directory.
Phase 18 also runs ``profile_frontend`` (6 frames at 320x240).
It prints a ``kernels`` JSON line (each kernel's launches on its main path
plus the stereo System's and phases 28-35's), the card's ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# The card's peaks, the f32 operations per (pixel, instance) pair and per
# projected instance that the bounds charge, and the timers and profiler
# call: gsorb_slam_tpu_torch/profiling/common.py.

# Raw rows the pose adjoint reads (mean 3, world covariance 6, live 1) and
# the screen rows whose cotangent moves the pose (u, v, conic 3, depth).
POSE_RAW_ROWS = 10
POSE_SCREEN_ROWS = (0, 1, 2, 3, 4, 9)
FRAMES = 10
MAP_CALLS = 5
MAP_ITERS = None  # None: MappingConfig's default (100)
N_WINDOW = 4  # mapping window: the identity frame and 3 poses 2 cm / 2 deg away

# Phases 12-13: the System's run lengths and the generated sequence's length.
SYS_FRAMES = 10
SYS_RERUN_FRAMES = 4
SYS_KERNEL_FRAMES = 4
SYS_SEQ_FRAMES = 100
# Phase 19: the frames written to disk, and run_benchmark's sequence length.
DISK_FRAMES = 5
BENCH_FRAMES = 3
# configs/tum1.yaml (the reference's Examples/RGB-D/tum/TUM1.yaml) as a dict.
TUM1 = {
    "Dataset": {"name": "tum_desk1", "type": "tum",
                "path": "datasets/TUM_RGBD/rgbd_dataset_freiburg1_desk"},
    "Camera": {"width": 640, "height": 480, "fx": 517.306408, "fy": 516.469215,
               "cx": 318.643040, "cy": 255.313989, "fps": 30.0},
    "Camera.k1": 0.262383, "Camera.k2": -0.953104, "Camera.p1": -0.005358,
    "Camera.p2": 0.002628, "Camera.k3": 1.163314, "Camera.bf": 40.0,
    "ThDepth": 40.0, "DepthMapFactor": 5000.0,
    "ORBextractor.nFeatures": 1000, "ORBextractor.scaleFactor": 1.2,
    "ORBextractor.nLevels": 8, "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7,
    "Mapping": {"numIters": 100, "imWeight": 1.0, "depthWeight": 0.7, "surDepthWeight": 0.35,
                "regLongWeight": 5.0, "regScalarWeight": 10, "lambda": 0.8,
                "lrsMean3D": 0.0001, "lrsRgb": 0.0025, "lrsUnnormRotation": 0.001,
                "lrsLogitOpacities": 0.05, "lrsLogScales": 0.001, "backgroundColor": 0.0,
                "pruneOpcities": 0.005, "scaleModifier": 1.0, "initScalarMethod": 2,
                "raduisDepthRatio": 3.0, "madienMul": 10, "useRadiusFilter": False},
    "Tracking": {"numIters": 200, "lrsCamQuat": 0.002, "lrsCamTrans": 0.00215,
                 "imWeight": 0.7, "featureWeight": 0.1, "depthWeight": 1.0,
                 "useSurDepth": True},
    "Debug": {"useWandb": False, "useLoop": True},
    "Evalution": {"enable": True, "savePly": True, "saveRootPath": "experiments"},
}

CAM_KW = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
N_SPLATS = 250_000
CAPACITY = 1 << 18
ITERS = 200
REBINS = (8, 40, 120)
T_INIT_TRANS = (0.01, -0.005, 0.008)
DEVICE = "cuda"


class Checks:
    def __init__(self):
        self.failed: list[str] = []

    def record(self, name: str, value: float, tol: float, ok: bool | None = None) -> bool:
        ok = bool(value <= tol) if ok is None else ok
        print(f"[{'ok' if ok else 'FAIL'}] {name}: {value:.3e} (tol {tol:.1e})", flush=True)
        if not ok:
            self.failed.append(name)
        return ok


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Device time per call of ``fn`` by CUDA events (``profiling.common.time_ms``:
    a sleep kernel ahead of each run, the best of 3 runs of ``reps`` calls)."""
    from gsorb_slam_tpu_torch.profiling.common import time_ms as time_calls

    return time_calls(fn, torch.device(DEVICE), reps)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def close_err(a, b, atol: float, rtol: float) -> float:
    """max(|a - b| / (atol + rtol |b|)): <= 1 means every element is within tolerance."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def psnr(img, ref) -> float:
    mse = float(((img - ref) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def axis_angle_pose(torch, axis, deg: float, trans, dev):
    """T_cw for a rotation of ``deg`` degrees about ``axis`` and a translation."""
    from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix

    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    h = math.radians(deg) / 2.0
    q = torch.tensor([math.cos(h), *(math.sin(h) * a)], dtype=torch.float32, device=dev)
    return pose_to_matrix(q, torch.tensor(trans, dtype=torch.float32, device=dev))


def applied_slots(torch, visit, K: int):
    """Visit words ``[..., ceil(K / 32)]`` (int32) -> ``[..., K]`` bool: the
    slots some lane of the warp applied."""
    bits = ((visit.long() & 0xFFFFFFFF)[..., None]
            >> torch.arange(32, device=visit.device)) & 1
    return bits.reshape(*visit.shape[:-1], -1)[..., :K].bool()


def check_tracking_kernel(torch, checks, label, kernel, plain, raw, q, t, cam, gt, gt_edges,
                          n_edge):
    """Phases 4, 10 and 11: a fused tracking kernel against its plain version
    on the pack ``raw`` projected at the pose (``q``, ``t``): the loss under
    both depth modes (1e-3 relative), the per-instance gradients with the
    loss-edge pixels left out (``gt_edges``, ``n_edge`` of them; 8e-4 +
    2e-3 |p|), and the pose gradient through K2f / K2b against the plain
    projection with autograd (2e-2 relative). ``kernel`` and ``plain`` map
    (screen, gt, use_sur) to (im_w image_l1, depth_w depth_l1, d_screen).
    Returns the gradients' max-abs error, the kernel's gradients with the
    median depth, and the screen pack."""
    from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
    from gsorb_slam_tpu_torch.raster.instances import rt_from_matrix, screen_rows
    from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
        preprocess_fwd,
        preprocess_instances_kernel,
    )

    with torch.no_grad():
        screen = preprocess_fwd(raw, rt_from_matrix(pose_to_matrix(q, t)).contiguous(), cam)
        for use_sur in (True, False):
            img_k, dep_k, _ = kernel(screen, gt, use_sur)
            img_p, dep_p, _ = plain(screen, gt, use_sur)
            torch.cuda.synchronize()
            lk, lp = float(img_k + dep_k), float(img_p + dep_p)
            checks.record(f"{label} use_sur={int(use_sur)} loss rel-err", abs(lk - lp) / abs(lp),
                          1e-3)
        # Per-instance gradients, leaving out the pixels where the loss is
        # discontinuous within rounding (see gt_without_loss_edges).
        print(f"# {label} gradient check: {n_edge} of {gt.shape[0] * gt.shape[2]} pixels left "
              f"out (loss discontinuous within rounding)", flush=True)
        for use_sur in (True, False):
            _, _, g_k = kernel(screen, gt_edges, use_sur)
            _, _, g_p = plain(screen, gt_edges, use_sur)
            ratio = (g_k - g_p).abs() / (8e-4 + 2e-3 * g_p.abs())
            if not checks.record(f"{label} use_sur={int(use_sur)} grads max "
                                 f"|k-p|/(8e-4+2e-3|p|)", float(ratio.max()), 1.0):
                t_i, r_i, k_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
                print(f"#   worst: tile {t_i} row {r_i} slot {k_i} kernel "
                      f"{float(g_k[t_i, r_i, k_i]):.6e} plain {float(g_p[t_i, r_i, k_i]):.6e}; "
                      f"{int((ratio > 1).sum())} elements out of tolerance, rows "
                      f"{sorted(set((ratio > 1).nonzero()[:, 1].tolist()))}", flush=True)
            if use_sur:
                err, d_screen = float((g_k - g_p).abs().max()), g_k

    def pose_grad(use_kernels: bool):
        qq = q.clone().requires_grad_(True)
        tt = t.clone().requires_grad_(True)
        with torch.enable_grad():
            rt = rt_from_matrix(pose_to_matrix(qq, tt))
            if use_kernels:
                scr = preprocess_instances_kernel(raw, rt, cam)
                _, _, d = kernel(scr.detach(), gt, True)
            else:
                scr = screen_rows(raw, rt, cam)
                _, _, d = plain(scr.detach(), gt, True)
            torch.autograd.backward(scr, d)
        return qq.grad, tt.grad

    gq_k, gt_k = pose_grad(True)
    gq_p, gt_p = pose_grad(False)
    checks.record(f"{label} pose grad (quat) rel-err, kernels vs plain", rel_err(gq_k, gq_p), 2e-2)
    checks.record(f"{label} pose grad (trans) rel-err, kernels vs plain", rel_err(gt_k, gt_p),
                  2e-2)
    return err, d_screen, screen


def phase_k2b_edges(torch, checks, raw, rt, d_screen, cam, sm) -> None:
    """Phase 3b: K2b in one launch, bit for bit on a rerun, and against its
    plain version (1e-3 relative) on ``adjoint_edge_pack``'s edge cases (the
    near plane, clips both ways, det <= 0, dead slots, zero cotangents) at a
    capacity that is not a multiple of 256, at one tile of one block, at
    one tile of two blocks and at T = 0 (zeros)."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.profiling.common import profile_call as profiled
    from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
        adjoint_edge_pack,
        preprocess_bwd,
        preprocess_bwd_plain,
    )

    a = preprocess_bwd(raw, rt, d_screen, cam, sm)
    n0 = _build.launches["preprocess_bwd"]
    b = preprocess_bwd(raw, rt, d_screen, cam, sm)
    checks.record("K2b two launches bitwise equal", 0.0, 0.0, ok=bool(torch.equal(a, b)))
    checks.record("K2b wrapper launches per call", _build.launches["preprocess_bwd"] - n0, 1,
                  ok=_build.launches["preprocess_bwd"] - n0 == 1)
    prof = profiled(lambda: preprocess_bwd(raw, rt, d_screen, cam, sm), torch.device(DEVICE))
    n_dev = None if prof is None else prof["launches"]
    print(f"# K2b device launches per call (torch.profiler): {n_dev}", flush=True)
    checks.record("K2b device launches per call (torch.profiler)", -1 if n_dev is None else n_dev,
                  1, ok=n_dev == 1)
    edge_cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    for n_tiles, cap in ((7, 300), (1, 256), (1, 300), (0, 300)):
        r, q, d, _ = (torch.as_tensor(x).to(DEVICE) for x in adjoint_edge_pack(
            0, n_tiles, cap, edge_cam))
        k = preprocess_bwd(r, q, d, edge_cam, 1.1)
        p = preprocess_bwd_plain(r, q, d, edge_cam, 1.1)
        same = bool(torch.equal(preprocess_bwd(r, q, d, edge_cam, 1.1), k))
        err = 0.0 if n_tiles == 0 and not k.any() and not p.any() else rel_err(k, p)
        checks.record(f"K2b edge pack T={n_tiles} cap={cap} rel-err vs plain", err, 1e-3)
        checks.record(f"K2b edge pack T={n_tiles} cap={cap} rerun bitwise", 0.0, 0.0, ok=same)


def check_capacity_padding(torch, checks, label, kernel, screen, gt, cap: int) -> None:
    """Phases 4 and 11: a tracking kernel's shared memory does not grow with
    the capacity (each backward window is staged from global memory), so
    the pack padded with dead slots to capacity ``cap`` launches and gives
    the loss and the gradients of the pack itself bit for bit, zeros in the
    padding."""
    n = screen.shape[2]
    with torch.no_grad():
        padded = torch.nn.functional.pad(screen, (0, cap - n)).contiguous()
        img, dep, g = kernel(screen, gt, True)
        img_c, dep_c, g_c = kernel(padded, gt, True)
        same = bool(torch.equal(img_c, img) and torch.equal(dep_c, dep)
                    and torch.equal(g_c[..., :n], g) and not g_c[..., n:].any())
    checks.record(f"{label} at capacity {cap} (dead slots padded) bitwise at {n}", 0.0, 0.0,
                  ok=same)


def phase_flat_kernels(torch, checks, gm, prep, bins_r, cam, rcfg) -> dict:
    """Phase 7: K4 / K5 against their plain versions on the render bins."""
    from gsorb_slam_tpu_torch.raster.binning import chunk_layout, tile_grid_shape
    from gsorb_slam_tpu_torch.raster.flat_kernels import (
        blend_flat,
        blend_flat_backward,
        blend_flat_backward_plain,
        blend_flat_forward,
        blend_flat_forward_plain,
        cotangent_without_gate_edges,
        footprint_keep_plain,
        pack_instances_flat,
    )
    from gsorb_slam_tpu_torch.raster.blend_kernels import flat_pack_grad_aux
    from gsorb_slam_tpu_torch.raster.preprocess import preprocess
    from gsorb_slam_tpu_torch.slam.mapping import window_chunk_budget

    ty, tx = tile_grid_shape(cam, rcfg)
    budget = window_chunk_budget(bins_r.counts[None], rcfg.chunk)
    cb = chunk_layout(bins_r, ty * tx, rcfg.chunk, budget)
    with torch.no_grad():
        packed = pack_instances_flat(prep, cb)
    print(f"# flat layout: {int(cb.n_chunks)} live chunks of {rcfg.chunk}, budget {budget}",
          flush=True)
    res = {}
    with torch.no_grad():
        for exact in (False, True):
            cfg = dataclasses.replace(rcfg, exact_stop=exact)
            out_k, ct_k, last_k, visit_k = blend_flat_forward(packed, cb, cam, cfg)
            out_p, ct_p, last_p, visit_p = blend_flat_forward_plain(packed, cb, cam, cfg)
            torch.cuda.synchronize()
            worst = 0.0
            for name, rows, tol in (("color", slice(0, 3), 2e-3), ("depth", slice(3, 4), 5e-3),
                                    ("alpha", slice(4, 5), 2e-3), ("median", slice(5, 6), 5e-3),
                                    ("final_t", slice(6, 7), 2e-3)):
                err = float((out_k[:, rows] - out_p[:, rows]).abs().max())
                checks.record(f"K4 exact={int(exact)} {name} max-abs vs plain", err, tol)
                worst = max(worst, err)
            err = float((ct_k - ct_p).abs().max())
            checks.record(f"K4 exact={int(exact)} chunk_t max-abs vs plain", err, 2e-3)
            n_last = int((last_k != last_p).sum())
            # The last applied slot moves only where a pixel's T sits at the
            # 1e-4 stop within rounding.
            checks.record(f"K4 exact={int(exact)} last-applied slots differing (share)",
                          n_last / last_k.numel(), 1e-4)
            # K5's visit words, exactly the plain version's.
            n_words = int((visit_k != visit_p).sum())
            print(f"# K4 exact={int(exact)} visit words: {n_words} of {visit_k.numel()} differ "
                  f"from the plain version's; {int(visit_k.ne(0).sum())} non-zero", flush=True)
            checks.record(f"K4 exact={int(exact)} visit words differing", n_words, 0)
            # K4's footprint cull keeps every slot a warp applied.
            keep = footprint_keep_plain(packed, cb, cam, cfg)
            applied = applied_slots(torch, visit_k, rcfg.chunk)
            n_lost = int((applied & ~keep).sum())
            print(f"# K4 exact={int(exact)} footprint cull: {int(keep.sum())} (warp, slot) pairs "
                  f"kept of {keep.numel()}, {int(applied.sum())} applied", flush=True)
            checks.record(f"K4 exact={int(exact)} applied slots the cull drops", n_lost, 0)
            if not exact:
                res["k4_err"] = max(worst, err)
                fwd = (out_k, ct_k, last_k, visit_k)

    # K5 under a seeded random cotangent of every differentiable row, with
    # the pixels where the blend is discontinuous within rounding left out.
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(fwd[0].shape, generator=gen).to(fwd[0].device)
    g[:, 5] = 0.0
    g[:, 7] = 0.0
    g, n_edge = cotangent_without_gate_edges(packed, cb, g, cam, rcfg)
    print(f"# K5 check: {n_edge} of {g.shape[0] * g.shape[2]} pixels left out (an alpha "
          f"within rounding of the 1/255 gate or the 0.99 clamp)", flush=True)
    d_k = blend_flat_backward(packed, cb, *fwd, g, cam, rcfg)
    d_p = blend_flat_backward_plain(packed, cb, g, cam, rcfg, tile_batch=300)
    torch.cuda.synchronize()
    ratio = (d_k - d_p).abs() / (8e-4 + 2e-3 * d_p.abs())
    if not checks.record("K5 grads max |k-p|/(8e-4+2e-3|p|)", float(ratio.max()), 1.0):
        c_i, r_i, k_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
        print(f"#   worst: chunk {c_i} row {r_i} slot {k_i} kernel {float(d_k[c_i, r_i, k_i]):.6e} "
              f"plain {float(d_p[c_i, r_i, k_i]):.6e}; {int((ratio > 1).sum())} elements out",
              flush=True)
    res["k5_err"] = float((d_k - d_p).abs().max())

    # Parameter gradients: K4 / K5 with the sorted pack backward against the
    # plain blend with autograd's scatter.
    aux = flat_pack_grad_aux(cb.indices, gm.capacity)
    names = ("means", "rgb", "quats", "logit_opacities", "log_scales")

    def param_grads(use_kernels: bool):
        ps = [getattr(gm, n).detach().clone().requires_grad_(True) for n in names]
        with torch.enable_grad():
            pr = preprocess(*ps, gm.active, torch.eye(4, device=g.device), cam)
            if use_kernels:
                out = blend_flat(pack_instances_flat(pr, cb, aux), cb, cam, rcfg)
                return torch.autograd.grad((out * g).sum(), ps)
            pk = pack_instances_flat(pr, cb)
            d = blend_flat_backward_plain(pk.detach(), cb, g, cam, rcfg, tile_batch=300)
            return torch.autograd.grad(pk, ps, d)

    for n, a, b in zip(names, param_grads(True), param_grads(False)):
        checks.record(f"param grad ({n}) rel-err, K4/K5 vs plain", rel_err(a, b), 2e-2)
    res.update(cb=cb, g=g)
    return res


def phase_mapping(torch, checks, gm, cam, rcfg, dev) -> dict:
    """Phases 8 and 9: the mapping step through K3 / K4 / K5 and its timings."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.config import MappingConfig
    from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess, render, render_binned
    from gsorb_slam_tpu_torch.slam.mapping import (
        build_window_frames,
        densify_frame,
        map_window,
        prune_map,
        window_chunk_budget,
        window_layouts,
    )
    from gsorb_slam_tpu_torch.splat.gaussians import prefix_view, prefix_writeback

    mcfg = MappingConfig()
    n_iters = MAP_ITERS or mcfg.num_iters
    s2 = 0.02 / math.sqrt(2.0)
    poses = [torch.eye(4, device=dev),
             axis_angle_pose(torch, (0, 1, 0), 2.0, (0.02, 0.0, 0.0), dev),
             axis_angle_pose(torch, (1, 0, 0), 2.0, (0.0, 0.02, 0.0), dev),
             axis_angle_pose(torch, (1, 1, 0), 2.0, (-s2, 0.0, s2), dev)][:N_WINDOW]

    def params(m):
        return (m.means, m.rgb, m.quats, m.logit_opacities, m.log_scales, m.active)

    with torch.no_grad():
        gts = []
        for P in poses:
            o = render(*params(gm), P, cam, rcfg)
            gts.append((o.color, torch.where(o.alpha > 0.5, o.median_depth,
                                             torch.zeros_like(o.alpha))))
        rng = np.random.default_rng(1)
        C = gm.capacity
        # The running max depth and scene radius a System takes from its
        # first frame (seed_from_frame); the bench map leaves them unset.
        max_z = gm.means[:, 2].max()
        gm_p = dataclasses.replace(
            gm,
            max_z=max_z,
            scene_radius=max_z / mcfg.radius_depth_ratio,
            rgb=torch.clamp(gm.rgb + torch.as_tensor(
                rng.normal(0, 0.1, (C, 3)).astype(np.float32), device=dev), 0.0, 1.0),
            logit_opacities=gm.logit_opacities + torch.as_tensor(
                rng.normal(0, 0.5, C).astype(np.float32), device=dev),
        )
        # Keyframe bins: the perturbed map at each window pose.
        kf_bins = [bin_gaussians(preprocess(*params(gm_p), P, cam), cam, rcfg) for P in poses[1:]]

    def mapping_step(start):
        """Prune, K3 render, densify and rebin at the identity frame."""
        m = prune_map(start, mcfg)
        pr = preprocess(*params(m), poses[0], cam)
        b = bin_gaussians(pr, cam, rcfg)
        out = render_binned(pr, b, cam, rcfg, bg=mcfg.background_color)
        m, n_add = densify_frame(m, out, *gts[0], poses[0], cam, mcfg,
                                 sat_tiles=b.counts >= rcfg.tile_capacity, rcfg=rcfg)
        cur = bin_gaussians(preprocess(*params(m), poses[0], cam), cam, rcfg)
        return m, n_add, cur

    def prefix_of(m) -> int:
        """The System's power-of-two bucket over the live prefix."""
        b = 1 << 14
        while b < int(m.count):
            b *= 2
        return min(b, m.capacity)

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        gm1, n_added, cur_bins = mapping_step(gm_p)
        frames = build_window_frames([c for c, _ in gts], [d for _, d in gts], poses,
                                     [cur_bins, *kf_bins], len(poses), len(poses), device=dev)
        budget = window_chunk_budget(frames.bins_counts, rcfg.chunk)
        prefix = prefix_of(gm1)
        draws = torch.randint(0, frames.n_frames, (n_iters,),
                              generator=torch.Generator().manual_seed(0)).tolist()
        gm_v, losses = map_window(prefix_view(gm1, prefix), frames, draws, cam, mcfg, rcfg,
                                  chunk_budget=budget)
        gm2 = prefix_writeback(gm1, gm_v)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    print(f"# mapping main path launches: {json.dumps(launches)}", flush=True)
    for name, want in (("blend_forward", 1), ("blend_flat_fwd", n_iters),
                       ("blend_flat_bwd", n_iters)):
        checks.record(f"{name} launches == {want}", launches[name], want,
                      ok=launches[name] == want)
    print(f"# mapping step: {int(n_added)} splats added by densify (count {int(gm1.count)}), "
          f"window of {frames.n_frames} frames, chunk budget {budget}, prefix {prefix}, "
          f"{step_s:.3f} s (first run)", flush=True)
    names = ("means", "rgb", "quats", "logit_opacities", "log_scales")
    finite = bool(torch.isfinite(losses).all()) and all(
        bool(torch.isfinite(getattr(gm2, n)).all()) for n in names)
    checks.record("mapping outputs finite", 0.0, 0.0, ok=finite)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"# mapping loss: first 10 iterations {first:.6f}, last 10 {last:.6f}", flush=True)
    checks.record("mapping loss, last 10 below first 10", last - first, 0.0, ok=last < first)
    with torch.no_grad():
        before = [psnr(render(*params(gm1), P, cam, rcfg).color, c) for P, (c, _) in zip(poses, gts)]
        after = [psnr(render(*params(gm2), P, cam, rcfg).color, c) for P, (c, _) in zip(poses, gts)]
    gain = float(np.mean(after) - np.mean(before))
    print(f"# window PSNR against the gt: before {', '.join(f'{v:.3f}' for v in before)}; "
          f"after {', '.join(f'{v:.3f}' for v in after)} dB", flush=True)
    checks.record("window mean PSNR gain after mapping (dB, at least)", gain, 1.0, ok=gain >= 1.0)

    def run():
        with torch.no_grad():
            return map_window(prefix_view(gm1, prefix), frames, draws, cam, mcfg, rcfg,
                              chunk_budget=budget)

    def same(m) -> bool:
        return all(torch.equal(getattr(m, n), getattr(gm_v, n)) for n in names)

    m_re, l_re = run()
    checks.record("mapping rerun bitwise equal", 0.0, 0.0, ok=same(m_re) and torch.equal(l_re, losses))

    # ---- 9. timings ----
    call_s = []
    equal = True
    for _ in range(MAP_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_t, _ = run()
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        equal &= same(m_t)
    checks.record(f"mapped map bitwise equal in {MAP_CALLS + 2} calls", 0.0, 0.0, ok=equal)
    q25, q50, q75 = (float(v) / n_iters * 1e3 for v in np.quantile(call_s, (0.25, 0.5, 0.75)))
    print(f"# map_window ms/iteration over {MAP_CALLS} calls of {n_iters} iterations: median "
          f"{q50:.4f}, quartiles {q25:.4f} / {q75:.4f}, best {min(call_s) / n_iters * 1e3:.4f}; "
          f"calls {', '.join(f'{v:.4f}' for v in call_s)} s", flush=True)
    profile_call(torch, run, min(call_s), "map_window call")

    layout = window_layouts(frames, gm1.capacity, cam, rcfg, budget)[0]
    return dict(gm=gm1, layout=layout, pose=poses[0], n_iters=n_iters, launches=launches,
                frames=frames, gts=gts, poses=poses)


def phase_system(torch, checks, dev) -> dict:
    """Phases 12 and 13: the RGB-D System over a generated TUM-like sequence,
    then its exact-stop and paired-rect tracking configurations."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.eval.ate import ate_rmse
    from gsorb_slam_tpu_torch.eval.evaluate import evaluate_sequence
    from gsorb_slam_tpu_torch.interop import system_config_from_dict
    from gsorb_slam_tpu_torch.slam.dataset import TUMLikeDataset
    from gsorb_slam_tpu_torch.slam.system import System
    from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES

    t0 = time.perf_counter()
    width, height = TUM1["Camera"]["width"], TUM1["Camera"]["height"]
    ds = TUMLikeDataset(n_frames=SYS_SEQ_FRAMES, width=width, height=height,
                        apply_distortion=False, noise=True, seed=0, device=dev)
    frames = [ds[i] for i in range(SYS_FRAMES)]
    moves = [np.linalg.norm(np.linalg.inv(b.gt_T_cw)[:3, 3] - np.linalg.inv(a.gt_T_cw)[:3, 3])
             for a, b in zip(frames[:-1], frames[1:])]
    print(f"# phase 12: TUM-like sequence of {SYS_SEQ_FRAMES} frames of {width}x{height} "
          f"generated in "
          f"{time.perf_counter() - t0:.2f} s; its first {SYS_FRAMES} frames move "
          f"{np.mean(moves) * 100:.2f} cm per frame on average", flush=True)
    cfg = system_config_from_dict(TUM1)
    raster = System.default_raster_config(width)

    def run(rcfg, n, snapshot_at=None):
        system = System(cfg, raster=rcfg, seed=0, device=dev)
        rows, snap = [], None
        for i, fr in enumerate(frames[:n]):
            tm = dict(system.timings)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            system.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            rows.append((wall, system.timings["track"] - tm["track"],
                         system.timings["map"] - tm["map"]))
            if i + 1 == snapshot_at:
                snap = {k: getattr(system.gm, k).clone() for k in PARAM_NAMES}
        return system, np.asarray(rows), snap

    def ate(system, n):
        return ate_rmse([r.T_cw for r in system.trajectory[:n]], [fr.gt_T_cw for fr in frames[:n]])

    torch.cuda.synchronize()
    _build.reset_launches()
    system, rows, snap = run(raster, SYS_FRAMES, snapshot_at=SYS_RERUN_FRAMES)
    torch.cuda.synchronize()
    k3_system = _build.launches["blend_forward"]
    # The frames already generated: the dataset would render them again.
    result = evaluate_sequence(system, frames, stride=1)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    print(f"# System main path launches: {json.dumps(launches)}; K3 within track_rgbd "
          f"{k3_system}", flush=True)
    mcfg = system.cfg.mapping
    n_track = sum(r.track_iters for r in system.trajectory[1:])
    n_map = mcfg.init_iters + mcfg.num_iters * (SYS_FRAMES - 1)
    for name, want in (("fused_track_fast", n_track), ("preprocess_fwd", n_track),
                       ("preprocess_bwd", n_track), ("blend_flat_fwd", n_map),
                       ("blend_flat_bwd", n_map), ("fused_track_exact", 0), ("paired_track", 0)):
        checks.record(f"System {name} launches == {want}", launches[name], want,
                      ok=launches[name] == want)
    # One densify render per tracked frame, then one evaluation render per frame.
    checks.record(f"System blend_forward launches in track_rgbd == {SYS_FRAMES - 1}",
                  k3_system, SYS_FRAMES - 1, ok=k3_system == SYS_FRAMES - 1)
    want_k3 = 2 * SYS_FRAMES - 1
    checks.record(f"System blend_forward launches with evaluation == {want_k3}",
                  launches["blend_forward"], want_k3, ok=launches["blend_forward"] == want_k3)
    poses = np.stack([r.T_cw for r in system.trajectory])
    checks.record("System poses finite", 0.0, 0.0,
                  ok=bool(np.isfinite(poses).all()) and len(poses) == SYS_FRAMES)
    print(f"# System evaluation: {json.dumps(result)}", flush=True)
    checks.record("System ATE RMSE (m, Horn-aligned)", result["ate_rmse"], 0.02)
    checks.record("System PSNR (dB, at least)", result["psnr"], 18.0, ok=result["psnr"] >= 18.0)
    per_frame_err = [float(np.linalg.norm(np.linalg.inv(r.T_cw)[:3, 3]
                                          - np.linalg.inv(fr.gt_T_cw)[:3, 3]))
                     for r, fr in zip(system.trajectory, frames)]
    print(f"# System per-frame camera-centre error (mm, unaligned): "
          f"{', '.join(f'{e * 1e3:.2f}' for e in per_frame_err)}; tracking iterations "
          f"{[r.track_iters for r in system.trajectory]}; keyframes "
          f"{[r.frame_id for r in system.trajectory if r.is_keyframe]}", flush=True)
    summary = system.shutdown_summary()
    tracked = rows[1:]
    q25, q50, q75 = np.quantile(tracked[:, 0], (0.25, 0.5, 0.75))
    e2e = {
        "frame_s_median": float(q50), "frame_s_q25": float(q25), "frame_s_q75": float(q75),
        "fps": float(len(tracked) / tracked[:, 0].sum()),
        "track_s_per_frame": float(np.median(tracked[:, 1])),
        "map_s_per_frame": float(np.median(tracked[:, 2])),
        "rest_s_per_frame": float(np.median(tracked[:, 0] - tracked[:, 1] - tracked[:, 2])),
        "frame0_s": float(rows[0, 0]),
        "ate_rmse_m": result["ate_rmse"], "psnr_db": result["psnr"],
        "depth_l1_m": result["depth_l1"], "ssim": result["ssim"], "ms_ssim": result["ms_ssim"],
        "avg_tracking_s": summary["avg_tracking_s"], "avg_mapping_s": summary["avg_mapping_s"],
        "compile_s": summary["compile_s"], "gaussians": summary["total_gaussians"],
        "keyframes": summary["n_keyframes"], "bin_dropped_frac": summary["bin_dropped_frac"],
    }
    print(f"# System end to end (frames 1-{SYS_FRAMES - 1}; frame 0 is the seed and "
          f"{mcfg.init_iters} warm-up iterations): {json.dumps(e2e)}", flush=True)
    print(f"# System frame wall times (s): {', '.join(f'{v:.4f}' for v in rows[:, 0])}",
          flush=True)
    nxt = ds[SYS_FRAMES]
    profile_call(torch, lambda: system.track_rgbd(nxt.rgb, nxt.depth, nxt.timestamp),
                 float(tracked[:, 0].min()), f"System frame {SYS_FRAMES}")

    # A second System over the first frames from the same seed: the same
    # trajectory and map, bit for bit.
    system2, _, _ = run(raster, SYS_RERUN_FRAMES)
    same = all(np.array_equal(a.T_cw, b.T_cw)
               for a, b in zip(system2.trajectory, system.trajectory[:SYS_RERUN_FRAMES]))
    same &= all(torch.equal(getattr(system2.gm, k), snap[k]) for k in PARAM_NAMES)
    checks.record(f"System rerun of {SYS_RERUN_FRAMES} frames bitwise equal", 0.0, 0.0, ok=same)
    del system, system2, snap

    # ---- 13. the exact-stop and paired-rect configurations ----
    out = {"e2e": e2e, "launches": launches, "frames": frames}
    for label, kw, kname in (("exact_stop", dict(exact_stop=True), "fused_track_exact"),
                             ("paired", dict(paired=True), "paired_track")):
        torch.cuda.synchronize()
        _build.reset_launches()
        sys_m, rows_m, _ = run(dataclasses.replace(raster, **kw), SYS_KERNEL_FRAMES)
        torch.cuda.synchronize()
        lm = dict(_build.launches)
        n_it = sum(r.track_iters for r in sys_m.trajectory[1:])
        print(f"# System {label}=True launches: {json.dumps(lm)}; frame wall times (s) "
              f"{', '.join(f'{v:.4f}' for v in rows_m[:, 0])}; frames 1-{SYS_KERNEL_FRAMES - 1}: "
              f"tracking {np.median(rows_m[1:, 1]):.4f} s, mapping {np.median(rows_m[1:, 2]):.4f}"
              f" s per frame (medians); tracking iterations "
              f"{[r.track_iters for r in sys_m.trajectory]}", flush=True)
        checks.record(f"System {label} {kname} launches == {n_it}", lm[kname], n_it,
                      ok=lm[kname] == n_it and n_it > 0)
        checks.record(f"System {label} fused_track_fast launches == 0", lm["fused_track_fast"],
                      0, ok=lm["fused_track_fast"] == 0)
        checks.record(f"System {label} ATE RMSE over {SYS_KERNEL_FRAMES} frames (m)",
                      ate(sys_m, SYS_KERNEL_FRAMES), 0.02)
        out[kname] = lm[kname]
        del sys_m
    return out


class _RecordSystems:
    """Within the block, every System that ``slam.system.System`` makes (an
    app's, inside its ``main``) is appended to ``made``."""

    def __init__(self):
        self.made = []

    def __enter__(self):
        from gsorb_slam_tpu_torch.slam import system as SM

        made, base = self.made, SM.System

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        self._base = base
        SM.System = Recorded
        return self

    def __exit__(self, *exc):
        from gsorb_slam_tpu_torch.slam import system as SM

        SM.System = self._base


def _quiet_call(fn, *args):
    """``fn(*args)`` with its standard output captured; returns (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue()


def phase_disk(torch, checks, dev, frames, tmp: str) -> dict:
    """Phase 19: the disk path. Phase 12's first DISK_FRAMES frames exported
    in the TUM layout and read back; ``run_rgbd`` over the directory on the
    card (TUM1 as a ``.json`` file), ``eval_ate`` on its trajectory,
    ``replay`` of its PLY, 2 frames through the JPEG layouts, and
    ``run_benchmark --frontend render --no-distortion``."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.apps import eval_ate, replay, run_benchmark, run_rgbd
    from gsorb_slam_tpu_torch.slam import dataset as D

    n = DISK_FRAMES
    codec = D.image_codec_name()
    print(f"# image codec on this machine: {codec or 'none (neither cv2 nor Pillow imports)'}",
          flush=True)
    seq = os.path.join(tmp, "tum")
    t0 = time.perf_counter()
    D.export_tum_format(frames[:n], seq)
    export_s = (time.perf_counter() - t0) / n
    ds = D.open_dataset("tum", seq, 5000.0)
    checks.record(f"disk: {n} rgb / depth pairs associated", len(ds), n, ok=len(ds) == n)
    t0 = time.perf_counter()
    read = [ds[i] for i in range(len(ds))]
    read_s = (time.perf_counter() - t0) / max(len(read), 1)
    # The exporter truncates to 8 bits (as the JAX package's does, so the
    # files are the same): the read-back rgb is that quantization exactly,
    # within one quantum of the generated frame.
    q_err = max(float(np.abs(r.rgb - np.floor(np.clip(f.rgb * 255.0, 0, 255)) / 255.0).max())
                for r, f in zip(read, frames))
    rgb_err = max(float(np.abs(r.rgb - f.rgb).max()) for r, f in zip(read, frames))
    d_err = max(float(np.abs(r.depth - f.depth)[f.depth > 0].max()) for r, f in zip(read, frames))
    d_zero = all(bool((r.depth[f.depth == 0] == 0).all()) for r, f in zip(read, frames))
    pose_err = max(float(np.abs(r.gt_T_cw - f.gt_T_cw).max()) for r, f in zip(read, frames))
    checks.record("disk: rgb read back equal to its 8-bit export", q_err, 0.0)
    checks.record("disk: rgb read back against the generated frame", rgb_err, 1 / 255 + 1e-6)
    checks.record("disk: depth read back where valid (m)", d_err, 1.5 / 5000,
                  ok=d_err <= 1.5 / 5000 and d_zero)
    checks.record("disk: ground-truth poses read back", pose_err, 1e-5)
    print(f"# phase 19: TUM layout of {n} VGA frames: export {export_s * 1e3:.1f} ms per "
          f"frame, read ({codec}, PNG files {codec} wrote) {read_s * 1e3:.1f} ms per frame",
          flush=True)

    cfg_path = os.path.join(tmp, "tum1.json")
    with open(cfg_path, "w") as f:
        json.dump({**TUM1, "Dataset": {**TUM1["Dataset"], "path": seq}}, f)
    out = os.path.join(tmp, "run")
    torch.cuda.synchronize()
    _build.reset_launches()
    with _RecordSystems() as rec:
        rc, _ = _quiet_call(run_rgbd.main, ["--config", cfg_path, "--type", "tum", "--dataset",
                                            seq, "--max-frames", str(n), "--eval-stride", "1",
                                            "--out", out])
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    checks.record("disk: run_rgbd exit code", rc, 0, ok=rc == 0)
    (system,) = rec.made
    with open(os.path.join(out, "result.txt")) as f:
        result = json.loads(f.read().splitlines()[-1])
    print(f"# run_rgbd on the disk sequence: {json.dumps(result)}; launches "
          f"{json.dumps(launches)}", flush=True)
    checks.record("disk: run_rgbd ATE RMSE (m)", result["ate_rmse"], 0.02)
    checks.record("disk: run_rgbd PSNR (dB, at least)", result["psnr"], 18.0,
                  ok=result["psnr"] >= 18.0)
    mcfg = system.cfg.mapping
    n_track = sum(r.track_iters for r in system.trajectory[1:])
    n_map = mcfg.init_iters + mcfg.num_iters * (n - 1)
    for name, want in (("fused_track_fast", n_track), ("preprocess_fwd", n_track),
                       ("preprocess_bwd", n_track), ("blend_flat_fwd", n_map),
                       ("blend_flat_bwd", n_map), ("blend_forward", 2 * n - 1)):
        checks.record(f"disk: run_rgbd {name} launches == {want}", launches[name], want,
                      ok=launches[name] == want and want > 0)
    written = all(os.path.getsize(os.path.join(out, name)) > 0 for name in (
        "CameraTrajectory_TUM.txt", "CameraTrajectory.txt", "GaussianModel.ply"))
    checks.record("disk: trajectory and PLY written", 0.0, 0.0, ok=written)
    e2e = {k: result[k] for k in ("median_frame_s", "mean_frame_s", "avg_tracking_s",
                                  "avg_mapping_s", "compile_s", "ate_rmse", "psnr",
                                  "depth_l1")}
    e2e["read_ms_per_frame"] = read_s * 1e3
    print(f"# disk run end to end (frame 0 is the seed and {mcfg.init_iters} warm-up "
          f"iterations): {json.dumps(e2e)}", flush=True)

    est = os.path.join(out, "CameraTrajectory_TUM.txt")
    rc, text = _quiet_call(eval_ate.main, [os.path.join(seq, "groundtruth.txt"), est])
    print(f"# eval_ate: {' | '.join(text.strip().splitlines())}", flush=True)
    rmse = float(text.split("rmse ")[1].split()[0]) if rc == 0 else math.inf
    checks.record("disk: eval_ate RMSE against result.txt's ATE (m)",
                  abs(rmse - result["ate_rmse"]), 1e-5)

    torch.cuda.synchronize()
    _build.reset_launches()
    rc, text = _quiet_call(replay.main, ["--ply", os.path.join(out, "GaussianModel.ply"),
                                         "--traj", est, "--config", cfg_path, "--dataset", seq,
                                         "--type", "tum", "--stride", "1"])
    torch.cuda.synchronize()
    rep = json.loads(text.strip().splitlines()[-1])
    print(f"# replay: {json.dumps(rep)}; launches {json.dumps(_build.launches)}", flush=True)
    checks.record("disk: replay PSNR (dB, at least)", rep["psnr"], 18.0,
                  ok=rc == 0 and rep["psnr"] >= 18.0 and rep["frames"] == n)
    checks.record(f"disk: replay blend_forward launches == {n}", _build.launches["blend_forward"],
                  n, ok=_build.launches["blend_forward"] == n)

    for layout in ("replica", "scannet"):
        root = os.path.join(tmp, layout)
        getattr(D, f"export_{layout}_format")(frames[:2], root)
        back = D.open_dataset(layout, root, 5000.0)
        tol = 1.5 / 6553.5 if layout == "replica" else 1.5e-3
        ok = len(back) == 2
        for i in range(2):
            fr, src = back[i], frames[i]
            ok &= float(np.abs(fr.rgb - src.rgb).mean()) < 6.0 / 255.0
            ok &= float(np.abs(fr.depth - src.depth)[src.depth > 0].max()) < tol
            ok &= float(np.abs(fr.gt_T_cw - src.gt_T_cw).max()) < 1e-5
        checks.record(f"disk: 2 frames round-trip through the {layout} layout", 0.0, 0.0,
                      ok=ok)

    bench_out = os.path.join(tmp, "bench")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launches()
    bench, _ = _quiet_call(run_benchmark.main, [
        "--frontend", "render", "--no-distortion", "--frames", str(BENCH_FRAMES),
        "--cache", os.path.join(tmp, "cache"), "--out", bench_out])
    torch.cuda.synchronize()
    print(f"# run_benchmark --frontend render --no-distortion --frames {BENCH_FRAMES}: "
          f"{json.dumps(bench)}; launches {json.dumps(_build.launches)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # Its sequence spans the 100-frame sweep in BENCH_FRAMES frames, so the
    # frames lie far apart: the run is held to finite results, not to an ATE.
    checks.record("disk: run_benchmark ran on the card with finite results", 0.0, 0.0,
                  ok=bench["backend"] == "cuda" and bench["frames"] == BENCH_FRAMES
                  and math.isfinite(bench["ate_rmse_m"]) and math.isfinite(bench["psnr_db"])
                  and bench["trunc_oracle_dropped"] == 0)
    return {"e2e": e2e, "launches": launches, "replay": rep, "codec": codec, "bench": bench,
            "system": system, "ply": os.path.join(out, "GaussianModel.ply"), "traj": est,
            "cfg_path": cfg_path}


def phase_scale_inits(torch, checks, dev, frames, tmp: str) -> dict:
    """Phase 20: the render path's leftovers on phase 12's first 3 frames.
    System A (``initScalarMethod`` 0) with frame 1 traced, then ``reset()``
    and the 3 frames again; System B (``initScalarMethod`` 1); the
    Morton-window 3-NN on the card against the CPU on frame 0's candidates;
    the exact 3-NN's host time per densify."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.camera import Camera, backproject, pixel_grid
    from gsorb_slam_tpu_torch.eval.ate import ate_rmse
    from gsorb_slam_tpu_torch.interop import system_config_from_dict
    from gsorb_slam_tpu_torch.ops import knn
    from gsorb_slam_tpu_torch.slam.system import System

    seq = frames[:3]
    knn_s = []
    exact = knn.knn3_mean_sq_dist_exact

    def timed_exact(pts, valid):
        t0 = time.perf_counter()
        out = exact(pts, valid)
        knn_s.append(time.perf_counter() - t0)
        return out

    def system_for(method):
        cfg = system_config_from_dict(
            {**TUM1, "Mapping": {**TUM1["Mapping"], "initScalarMethod": method}})
        return System(cfg, raster=System.default_raster_config(cfg.camera.width), seed=0,
                      device=dev)

    def ate(system):
        return ate_rmse([r.T_cw for r in system.trajectory], [f.gt_T_cw for f in seq])

    knn.knn3_mean_sq_dist_exact = timed_exact
    try:
        sys_a = system_for(0)
        sys_a.track_rgbd(seq[0].rgb, seq[0].depth, seq[0].timestamp)
        sys_a.start_trace(os.path.join(tmp, "trace"))
        sys_a.track_rgbd(seq[1].rgb, seq[1].depth, seq[1].timestamp)
        trace = sys_a.stop_trace()
        sys_a.track_rgbd(seq[2].rgb, seq[2].depth, seq[2].timestamp)
        with open(trace) as f:
            text = f.read()
        names = ("fused_track_kernel", "blend_flat_fwd_kernel")
        print(f"# phase 20: trace of System A's frame 1: {os.path.getsize(trace)} bytes; "
              + ", ".join(f"{k} {text.count(k)} times" for k in names), flush=True)
        checks.record("scale inits: the trace names K1's and K4's kernels", 0.0, 0.0,
                      ok=all(k in text for k in names))
        del text
        ate_first = ate(sys_a)
        sys_a.reset()
        checks.record("scale inits: reset() clears the session", 0.0, 0.0,
                      ok=sys_a.frame_id == 0 and sys_a.keyframes == []
                      and int(sys_a.gm.count) == 0 and sys_a.trajectory == []
                      and np.array_equal(sys_a.velocity, np.eye(4, dtype=np.float32)))
        torch.cuda.synchronize()
        _build.reset_launches()
        for fr in seq:
            sys_a.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        poses = np.stack([r.T_cw for r in sys_a.trajectory])
        checks.record("scale inits: method 0 poses after reset() finite", 0.0, 0.0,
                      ok=bool(np.isfinite(poses).all()) and len(poses) == 3)
        ate_a = ate(sys_a)
        checks.record("scale inits: method 0 ATE RMSE after reset() (m)", ate_a, 0.02)
        mcfg = sys_a.cfg.mapping
        n_track = sum(r.track_iters for r in sys_a.trajectory[1:])
        n_map = mcfg.init_iters + 2 * mcfg.num_iters
        for name, want in (("fused_track_fast", n_track), ("preprocess_fwd", n_track),
                           ("preprocess_bwd", n_track), ("blend_flat_fwd", n_map),
                           ("blend_flat_bwd", n_map), ("blend_forward", 2)):
            checks.record(f"scale inits: method 0 {name} launches == {want}", launches[name],
                          want, ok=launches[name] == want and want > 0)
        summ_a = sys_a.shutdown_summary()
        del sys_a

        sys_b = system_for(1)
        for fr in seq:
            sys_b.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
        ate_b = ate(sys_b)
        checks.record("scale inits: method 1 ATE RMSE (m)", ate_b, 0.02)
        summ_b = sys_b.shutdown_summary()
        del sys_b
    finally:
        knn.knn3_mean_sq_dist_exact = exact
    print(f"# scale inits: method 0 ATE {ate_first:.6f} m (first session), {ate_a:.6f} m "
          f"(after reset), {summ_a['total_gaussians']} splats; method 1 ATE {ate_b:.6f} m, "
          f"{summ_b['total_gaussians']} splats; launches after reset {json.dumps(launches)}",
          flush=True)
    print(f"# exact 3-NN on the host, per densify (s; {seq[0].depth.size} candidates each, "
          f"3 sessions x 3 frames): {', '.join(f'{v:.4f}' for v in knn_s)}; median "
          f"{float(np.median(knn_s)):.4f}", flush=True)

    # The Morton-window version on frame 0's candidates, card against CPU.
    cc = system_config_from_dict(TUM1).camera
    cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
    depth = torch.as_tensor(seq[0].depth)
    pts = backproject(cam, pixel_grid(cam, device="cpu"), depth).reshape(-1, 3).contiguous()
    valid = (depth > 0).reshape(-1)
    want = knn.knn3_mean_sq_dist(pts, valid)
    p_d, v_d = pts.to(dev), valid.to(dev)
    got = knn.knn3_mean_sq_dist(p_d, v_d)
    torch.cuda.synchronize()
    window_ms = time_ms(torch, lambda: knn.knn3_mean_sq_dist(p_d, v_d), 5)
    w = want.numpy()
    rel = float((np.abs(got.cpu().numpy() - w) / np.maximum(np.abs(w), 1e-30)).max())
    codes_equal = torch.equal(knn.morton_codes(p_d, v_d).cpu(), knn.morton_codes(pts, valid))
    print(f"# Morton-window 3-NN on {int(valid.sum())} of {len(valid)} candidates: "
          f"{window_ms:.3f} ms on the card; Morton codes equal to the CPU's: {codes_equal}",
          flush=True)
    checks.record("scale inits: Morton-window 3-NN, card against CPU (relative)", rel, 1e-6,
                  ok=rel <= 1e-6 and codes_equal)
    return {"knn_exact_s": knn_s, "window_ms": window_ms, "ate": (ate_a, ate_b)}


def phase_blend_backward(torch, checks, gm, packed, bins_r, cam, rcfg) -> dict:
    """Phase 14: K6 against its plain version on phase 2's render bins at the
    identity pose, under both stop rules, with K3's residuals (its visit
    words included), a seeded random cotangent on rows 0-4 and the final T
    row and the gate-edge pixels left out, over a NaN-filled block; two
    launches bitwise equal; the parameter gradients of the render through
    the pack and ``preprocess`` (background 0.3) against the plain chain."""
    from gsorb_slam_tpu_torch.raster.blend_kernels import (
        blend,
        blend_backward,
        blend_backward_plain,
        blend_forward,
        pack_instances,
        render_output_from_tiles,
        tile_cotangent_without_gate_edges,
    )
    from gsorb_slam_tpu_torch.raster.preprocess import preprocess

    counts = bins_r.counts
    res = {}
    for exact in (False, True):
        cfg = dataclasses.replace(rcfg, exact_stop=exact)
        with torch.no_grad():
            fwd = blend_forward(packed, counts, cam, cfg)
        out = fwd[0]
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(11)).to(out.device)
        g[:, 5] = 0.0
        g[:, 7] = 0.0
        g, n_edge = tile_cotangent_without_gate_edges(packed, g, cam, cfg)
        print(f"# K6 exact={int(exact)} check: {n_edge} of {g.shape[0] * g.shape[2]} pixels left "
              f"out (an alpha within rounding of the 1/255 gate or the 0.99 clamp)", flush=True)
        # The caching allocator hands K6 a block full of NaN: K6 writes every
        # element itself.
        torch.empty(packed.shape, device=packed.device).fill_(float("nan"))
        d_k = blend_backward(packed, counts, *fwd[1:], g, cam, cfg)
        d_p = blend_backward_plain(packed, counts, g, cam, cfg, tile_batch=150)
        torch.cuda.synchronize()
        ratio = (d_k - d_p).abs() / (8e-4 + 2e-3 * d_p.abs())
        if not checks.record(f"K6 exact={int(exact)} grads max |k-p|/(8e-4+2e-3|p|)",
                             float(ratio.max()), 1.0):
            t_i, r_i, k_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
            print(f"#   worst: tile {t_i} row {r_i} slot {k_i} kernel {float(d_k[t_i, r_i, k_i]):.6e}"
                  f" plain {float(d_p[t_i, r_i, k_i]):.6e}; {int((ratio > 1).sum())} elements out",
                  flush=True)
        again = blend_backward(packed, counts, *fwd[1:], g, cam, cfg)
        checks.record(f"K6 exact={int(exact)} two launches bitwise equal", 0.0, 0.0,
                      ok=bool(torch.equal(again, d_k)))
        if not exact:
            res.update(k6_err=float((d_k - d_p).abs().max()), resid=fwd[1:], g=g)
        del d_k, d_p, again, ratio

    # Parameter gradients: the render's colour, depth, alpha and final T
    # under seeded weights with a background of 0.3, through K3 / K6 and the
    # sorted pack backward, against the plain blend backward on the same
    # pack (the pack and preprocess by autograd).
    names = ("means", "rgb", "quats", "logit_opacities", "log_scales")
    gen = torch.Generator().manual_seed(12)
    w = [torch.randn((cam.height, cam.width) + sh, generator=gen).to(packed.device)
         for sh in ((3,), (), (), ())]

    def loss_of(out, radius):
        ro = render_output_from_tiles(out, cam, rcfg, 0.3, radius)
        return sum((x * wi).sum() for x, wi in zip((ro.color, ro.depth, ro.alpha, ro.final_t), w))

    def param_grads(use_kernels: bool):
        ps = [getattr(gm, n).detach().clone().requires_grad_(True) for n in names]
        with torch.enable_grad():
            pr = preprocess(*ps, gm.active, torch.eye(4, device=packed.device), cam)
            pk = pack_instances(pr, bins_r)
            if use_kernels:
                return torch.autograd.grad(loss_of(blend(pk, counts, cam, rcfg), pr.radius), ps)
            leaf = torch.zeros((pk.shape[0], 8, g.shape[2]), device=pk.device, requires_grad=True)
            (g_out,) = torch.autograd.grad(loss_of(leaf, pr.radius), leaf)
            d = blend_backward_plain(pk.detach(), counts, g_out, cam, rcfg, tile_batch=150)
            return torch.autograd.grad(pk, ps, d)

    for n, a, b in zip(names, param_grads(True), param_grads(False)):
        checks.record(f"render param grad ({n}) rel-err, K3/K6 vs plain", rel_err(a, b), 2e-2)
    return res


def phase_mesh(torch, checks, mp, cam, rcfg, dev) -> dict:
    """Phase 15: the window-sharded mapping (``parallel_window_step``) on a
    one-rank NCCL group, from phase 8's map after its prune and densify over
    its 4-frame window."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.config import MappingConfig
    from gsorb_slam_tpu_torch.parallel import mesh as PM
    from gsorb_slam_tpu_torch.raster import render
    from gsorb_slam_tpu_torch.raster.binning import TileBins
    from gsorb_slam_tpu_torch.raster.blend_kernels import tile_pack_grad_aux
    from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES

    mcfg = MappingConfig()
    n_iters = MAP_ITERS or mcfg.num_iters
    mesh = PM.make_mesh()
    frames = PM.shard_frames(mp["frames"], mesh)
    print(f"# phase 15: mesh of {mesh.size} rank(s), {frames.colors.shape[0]} window frames "
          f"on this rank, map capacity {mp['gm'].capacity}", flush=True)

    def run():
        gm = PM.replicate_map(mp["gm"], mesh)
        aux = PM.window_pack_aux(frames, gm.capacity)
        losses = []
        with torch.no_grad():
            for it in range(n_iters):
                gm, loss = PM.parallel_window_step(gm, frames, mesh, cam, mcfg, rcfg,
                                                   local_idx=it, pack_aux=aux)
                losses.append(loss)
        return gm, torch.stack(losses)

    torch.cuda.synchronize()
    _build.reset_launches()
    n_ar = mesh.collectives["all_reduce"]
    t0 = time.perf_counter()
    gm2, losses = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    n_ar = mesh.collectives["all_reduce"] - n_ar
    print(f"# window-sharded mapping launches: {json.dumps(launches)}; all_reduce calls {n_ar}",
          flush=True)
    for name, want in (("blend_forward", n_iters), ("blend_backward", n_iters),
                       ("blend_flat_fwd", 0), ("blend_flat_bwd", 0)):
        checks.record(f"mesh mapping {name} launches == {want}", launches[name], want,
                      ok=launches[name] == want)
    checks.record(f"mesh mapping all_reduce calls == {n_iters}", n_ar, n_iters, ok=n_ar == n_iters)
    finite = bool(torch.isfinite(losses).all()) and all(
        bool(torch.isfinite(getattr(gm2, n)).all()) for n in PARAM_NAMES)
    checks.record("mesh mapping outputs finite", 0.0, 0.0, ok=finite)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"# mesh mapping loss: first 10 steps {first:.6f}, last 10 {last:.6f}; first call "
          f"{first_s:.3f} s", flush=True)
    checks.record("mesh mapping loss, last 10 below first 10", last - first, 0.0, ok=last < first)

    def params(m):
        return (m.means, m.rgb, m.quats, m.logit_opacities, m.log_scales, m.active)

    with torch.no_grad():
        before = [psnr(render(*params(mp["gm"]), P, cam, rcfg).color, c)
                  for P, (c, _) in zip(mp["poses"], mp["gts"])]
        after = [psnr(render(*params(gm2), P, cam, rcfg).color, c)
                 for P, (c, _) in zip(mp["poses"], mp["gts"])]
    gain = float(np.mean(after) - np.mean(before))
    print(f"# mesh mapping window PSNR: before {', '.join(f'{v:.3f}' for v in before)}; after "
          f"{', '.join(f'{v:.3f}' for v in after)} dB", flush=True)
    checks.record("mesh mapping window mean PSNR gain (dB, at least)", gain, 1.0, ok=gain >= 1.0)

    call_s, equal = [], True
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm_t, l_t = run()
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        equal &= all(torch.equal(getattr(gm_t, n), getattr(gm2, n)) for n in PARAM_NAMES)
        equal &= bool(torch.equal(l_t, losses))
    checks.record("mesh mapping reruns bitwise equal (3 calls)", 0.0, 0.0, ok=equal)
    q25, q50, q75 = (float(v) / n_iters * 1e3 for v in np.quantile(call_s, (0.25, 0.5, 0.75)))
    print(f"# parallel_window_step ms/step over 3 calls of {n_iters} steps: median {q50:.4f}, "
          f"quartiles {q25:.4f} / {q75:.4f}; calls {', '.join(f'{v:.4f}' for v in call_s)} s",
          flush=True)
    # One frame's slot table, which the loop builds once per frame and not
    # once per step (host clock: the build reads its width on the host).
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bins0 = TileBins(indices=frames.bins_indices[0], counts=frames.bins_counts[0],
                     n_dropped=frames.bins_counts.new_zeros(()))
    for _ in range(reps):
        tile_pack_grad_aux(bins0, mp["gm"].capacity)
    torch.cuda.synchronize()
    print(f"# one window frame's pack slot table: {(time.perf_counter() - t0) / reps * 1e3:.4f} "
          f"ms to build (wall)", flush=True)
    profile_call(torch, run, min(call_s), "window-sharded mapping call")
    return dict(mesh=mesh, launches=launches)


def phase_mesh_tracking(torch, checks, mesh, gm, T_init, gt_color, gt_depth, res_main, screen,
                        counts, gt4, cam, tcfg, rcfg_t) -> None:
    """Phase 16: ``parallel_track_frame`` at world size 1 against phase 5's
    ``track_frame``, and K1 over the two strided halves of the tile grid
    against one unsharded launch."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.parallel.tracking import parallel_track_frame, strided_tile_perm
    from gsorb_slam_tpu_torch.raster.blend_kernels import fused_track_launch
    from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches

    torch.cuda.synchronize()
    _build.reset_launches()
    n_ar = mesh.collectives["all_reduce"]
    t0 = time.perf_counter()
    with torch.no_grad():
        res = parallel_track_frame(gm, T_init, gt_color, gt_depth,
                                   FeatureMatches.empty(device=T_init.device), cam, tcfg, rcfg_t,
                                   mesh, rebin_iters=REBINS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    n_ar = mesh.collectives["all_reduce"] - n_ar
    print(f"# tile-sharded tracking launches: {json.dumps(launches)}; all_reduce calls {n_ar}; "
          f"{wall:.3f} s ({wall / ITERS * 1e3:.4f} ms/iteration, first run)", flush=True)
    for name in ("fused_track_fast", "preprocess_fwd", "preprocess_bwd"):
        checks.record(f"mesh tracking {name} launches == {ITERS}", launches[name], ITERS,
                      ok=launches[name] == ITERS)
    checks.record(f"mesh tracking all_reduce calls == {ITERS}", n_ar, ITERS, ok=n_ar == ITERS)
    d = float((res.T_cw - res_main.T_cw).abs().max())
    bitwise = bool(torch.equal(res.T_cw, res_main.T_cw))
    print(f"# mesh tracking pose vs track_frame: max-abs {d:.3e}, bitwise {bitwise}", flush=True)
    checks.record("mesh tracking pose vs track_frame max-abs", d, 1e-5)

    n_tiles = counts.shape[0]
    perm, is_pad = strided_tile_perm(n_tiles, 2, device=counts.device)
    im_w, depth_w = tcfg.im_weight, tcfg.depth_weight
    with torch.no_grad():
        loss_a, g_a = fused_track_launch(screen, counts, gt4, cam, rcfg_t, im_w, depth_w, True)
        total, rows_eq, grads_eq = 0.0, True, True
        half = perm.numel() // 2
        for s_ in range(2):
            tids = perm[s_ * half:(s_ + 1) * half].contiguous()
            rows, pad = tids.long(), is_pad[s_ * half:(s_ + 1) * half]
            cnt = torch.where(pad, torch.zeros_like(counts[rows]), counts[rows])
            loss_s, g_s = fused_track_launch(
                screen[rows].contiguous(), cnt, gt4[rows].contiguous(), cam, rcfg_t, im_w,
                depth_w, True, tile_ids=tids)
            live = ~pad
            rows_eq &= bool(torch.equal(loss_s[live], loss_a[rows][live]))
            grads_eq &= bool(torch.equal(g_s[live], g_a[rows][live]))
            total += float(loss_s.sum())
        full = float(loss_a.sum())
    checks.record("K1 strided halves: per-tile loss rows bitwise equal to one launch", 0.0, 0.0,
                  ok=rows_eq)
    checks.record("K1 strided halves: gradient rows bitwise equal to one launch", 0.0, 0.0,
                  ok=grads_eq)
    checks.record("K1 strided halves: summed loss rel-err", abs(total - full) / abs(full), 1e-6)


def phase_ablation(torch, checks, screen, gt4, cam, rcfg_t, im_w, depth_w) -> dict:
    """Phase 17: K9 against its plain version on phase 4's tracking pack,
    then K9's main path (``profile_fused_ablate``'s ``main``)."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.profiling import profile_fused_ablate
    from gsorb_slam_tpu_torch.raster.blend_kernels import (
        ABLATE_VARIANTS,
        ablate_view,
        fused_track_ablate_launch,
        gt_without_loss_edges,
        tracking_loss_grad_ablate,
        tracking_loss_grad_ablate_plain,
    )

    def kernel(gt, use_sur, variant="full"):
        return tracking_loss_grad_ablate(screen, gt, cam, rcfg_t, im_w, depth_w, use_sur,
                                         variant=variant)

    def plain(gt, use_sur):
        return tracking_loss_grad_ablate_plain(screen, gt, cam, rcfg_t, im_w, depth_w, use_sur)

    with torch.no_grad():
        for use_sur in (True, False):
            img_k, dep_k, _ = kernel(gt4, use_sur)
            img_p, dep_p, _ = plain(gt4, use_sur)
            lk, lp = float(img_k + dep_k), float(img_p + dep_p)
            checks.record(f"K9 full use_sur={int(use_sur)} loss rel-err", abs(lk - lp) / abs(lp),
                          1e-3)
        view, counts_f = ablate_view(screen, rcfg_t)
        gt_e, n_edge = gt_without_loss_edges(view, counts_f, gt4, cam, rcfg_t, stop=False)
        print(f"# K9 gradient check: {n_edge} of {gt4.shape[0] * gt4.shape[2]} pixels left out "
              f"(loss discontinuous within rounding)", flush=True)
        _, _, g_k = kernel(gt_e, True)
        _, _, g_p = plain(gt_e, True)
        torch.cuda.synchronize()
        ratio = (g_k - g_p).abs() / (8e-4 + 2e-3 * g_p.abs())
        if not checks.record("K9 full grads max |k-p|/(8e-4+2e-3|p|)", float(ratio.max()), 1.0):
            t_i, r_i, k_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
            print(f"#   worst: tile {t_i} row {r_i} slot {k_i} kernel "
                  f"{float(g_k[t_i, r_i, k_i]):.6e} plain {float(g_p[t_i, r_i, k_i]):.6e}; "
                  f"{int((ratio > 1).sum())} elements out of tolerance", flush=True)
        err = float((g_k - g_p).abs().max())
        launch = {v: fused_track_ablate_launch(screen, gt_e, cam, rcfg_t, im_w, depth_w, True, v)
                  for v in ABLATE_VARIANTS}
        again = fused_track_ablate_launch(screen, gt_e, cam, rcfg_t, im_w, depth_w, True, "full")
        checks.record("K9 full two launches bitwise equal (loss rows and gradients)", 0.0, 0.0,
                      ok=bool(torch.equal(again[0], launch["full"][0])
                              and torch.equal(again[1], launch["full"][1])
                              and torch.equal(launch["full"][1], g_k)))
        checks.record("K9 fwd loss rows bitwise equal to full's, gradients zero", 0.0, 0.0,
                      ok=bool(torch.equal(launch["fwd"][0], launch["full"][0])
                              and not launch["fwd"][1].any()))
        finite = [v for v, (lo, g) in launch.items()
                  if bool(torch.isfinite(lo).all()) and bool(torch.isfinite(g).all())]
        checks.record(f"K9 variants launched with finite outputs ({len(ABLATE_VARIANTS)})",
                      len(finite), len(ABLATE_VARIANTS), ok=len(finite) == len(ABLATE_VARIANTS))
        plain_ms = time_ms(torch, lambda: plain(gt4, True), 2)
        del launch, again, g_k, g_p, ratio

    # K9's main path: the ablation table at the bench tracking view.
    torch.cuda.synchronize()
    _build.reset_launches()
    table = profile_fused_ablate.main([])
    torch.cuda.synchronize()
    launches = _build.launches["fused_track_ablate"]
    print(f"# K9 main path (profile_fused_ablate) launches: {json.dumps(dict(_build.launches))}",
          flush=True)
    checks.record("K9 launched on its main path", launches, 1, ok=launches >= 1)
    ms = [r["ms"] for r in table["variants"].values()]
    checks.record("K9 ablation table: every variant timed, finite", 0.0, 0.0,
                  ok=len(ms) == len(ABLATE_VARIANTS) and all(math.isfinite(m) for m in ms))
    print(f"# K9 ablation table: {json.dumps(table)}", flush=True)
    return dict(err=err, plain_ms=plain_ms, launches=launches, table=table)


def phase_profilers(torch, checks) -> dict:
    """Phase 18: the profilers by their ``main``, each cut for time (see
    the module docstring); each must return finite numbers."""
    import importlib

    from gsorb_slam_tpu_torch import _build

    runs = {
        "profile_track": ["--runs", "1"],
        "profile_map_full": ["--iters", "20", "--runs", "1"],
        "profile_map_iter": [],
        "profile_raster": [],
        "profile_fused": [],
        "profile_paired_parts": [],
        "profile_gather": [],
        "profile_mapping_quality": ["--frames", "2", "--ablate", "base,freshbins"],
        "profile_frontend": ["--frames", "6"],
    }

    def finite(d) -> bool:
        if isinstance(d, dict):
            return all(finite(v) for v in d.values())
        if isinstance(d, (list, tuple)):
            return all(finite(v) for v in d)
        if isinstance(d, float):
            return math.isfinite(d)
        return True

    out = {}
    for name, argv in runs.items():
        print(f"# phase 18: {name} {' '.join(argv)}", flush=True)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = importlib.import_module(f"gsorb_slam_tpu_torch.profiling.{name}").main(argv)
        torch.cuda.synchronize()
        print(f"# {name}: {time.perf_counter() - t0:.1f} s; launches "
              f"{json.dumps({k: v for k, v in _build.launches.items() if v})}", flush=True)
        print(f"# {name} result: {json.dumps(res)}", flush=True)
        checks.record(f"{name} returned finite numbers on the card", 0.0, 0.0,
                      ok=res["device"] == "cuda" and finite(res))
        out[name] = res
    return out


# ---------------------------------------------------------------- ORB slice

ORB_FRAMES = 6  # phase 21: frames the frontend runs over (6 keyframes: one local BA of 6)
ORB_SYS_FRAMES = 6  # phase 22: the ORB System's run length
# Phase 23: the loop-closing scene of tests/test_loop_e2e.py.
LOOP_CAM = dict(fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72)


def _gray(torch, fr, dev):
    rgb = torch.as_tensor(fr.rgb, device=dev)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _to_cpu(torch, x):
    """Tensors (also inside tuples, lists, dicts and NamedTuples) moved to the CPU."""
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(torch, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(torch, v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(torch, v) for k, v in x.items()}
    return x


class _Capture:
    """Within the block, the arguments of the last call of ``module.name``
    (and the call count) are kept."""

    def __init__(self, module, name):
        self.module, self.name, self.args, self.kw, self.calls = module, name, None, None, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            self.args, self.kw = a, kw
            self.calls += 1
            return self.fn(*a, **kw)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_frontend(torch, checks, dev) -> dict:
    """Phase 21: the ORB frontend's modules on the card against the CPU on
    frames of the distorted TUM-like sequence (no kernel is involved)."""
    from gsorb_slam_tpu_torch.core.camera import Distortion
    from gsorb_slam_tpu_torch.core.config import ORBConfig
    from gsorb_slam_tpu_torch.frontend import ba, matcher, orb
    from gsorb_slam_tpu_torch.profiling.common import wall_ms
    from gsorb_slam_tpu_torch.slam import geometric as G
    from gsorb_slam_tpu_torch.slam.dataset import TUMLikeDataset

    width, height = TUM1["Camera"]["width"], TUM1["Camera"]["height"]
    t0 = time.perf_counter()
    ds = TUMLikeDataset(n_frames=SYS_SEQ_FRAMES, width=width, height=height,
                        apply_distortion=True, noise=True, seed=0, device=dev)
    frames = [ds[i] for i in range(max(ORB_SYS_FRAMES, ORB_FRAMES))]
    print(f"# phase 21: distorted TUM-like sequence of {SYS_SEQ_FRAMES} frames generated in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ocfg = ORBConfig()
    fe = G.GeometricFrontend(ds.cam, ocfg, dist=Distortion(*TUMLikeDataset.DIST), device=dev)
    checks.record("frontend pins full f32 on the card (TF32 off, cuDNN deterministic)", 0.0, 0.0,
                  ok=not torch.backends.cuda.matmul.allow_tf32
                  and not torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.deterministic)

    g0 = _gray(torch, frames[0], dev)
    f_card = orb.extract_orb(g0, ocfg)
    f_cpu = orb.extract_orb(g0.cpu(), ocfg)
    same_kp = all(torch.equal(getattr(f_card, k).cpu(), getattr(f_cpu, k))
                  for k in ("uv", "octave", "valid"))
    checks.record("extract_orb card == CPU: uv, octave, valid", 0.0, 0.0, ok=same_kp)
    valid = f_cpu.valid
    rows_eq = (f_card.descriptors.cpu() == f_cpu.descriptors).all(1)[valid]
    share = float(rows_eq.float().mean())
    checks.record(f"extract_orb descriptors bit for bit on >= 99% of the {int(valid.sum())} "
                  f"valid rows", share, 0.99, ok=share >= 0.99)
    checks.record("extract_orb response card vs CPU (max abs)",
                  float((f_card.response.cpu() - f_cpu.response).abs().max()), 1e-5)
    checks.record("extract_orb angle card vs CPU on valid rows (rad)",
                  float((f_card.angle.cpu() - f_cpu.angle)[valid].abs().max()), 1e-4)
    f1 = orb.extract_orb(_gray(torch, frames[1], dev), ocfg)
    D_card = matcher.hamming_matrix(f_card.descriptors, f1.descriptors)
    D_cpu = matcher.hamming_matrix(f_card.descriptors.cpu(), f1.descriptors.cpu())
    checks.record("hamming_matrix card == CPU", 0.0, 0.0, ok=bool(torch.equal(D_card.cpu(), D_cpu)))

    # The frontend over the first frames at the ground-truth poses, a
    # keyframe each frame (one local BA over 6 keyframes at the 6th).
    with _Capture(G.ba, "pose_optimization") as po, \
            _Capture(G.ba, "local_bundle_adjustment") as lba, \
            _Capture(G, "search_by_projection") as sbp:
        fe.create_keyframe(fe._extract(g0), frames[0].depth, frames[0].gt_T_cw, 0)
        for i in range(1, ORB_FRAMES):
            res = fe.process_frame(_gray(torch, frames[i], dev), frames[i].gt_T_cw)
            fe.create_keyframe(res.feats, frames[i].depth, frames[i].gt_T_cw, i)
    torch.cuda.synchronize()
    print(f"# frontend over {ORB_FRAMES} frames: {len(fe.keyframes)} keyframes, "
          f"{int(fe.pt_valid.sum())} map points; pose optimizations {po.calls}, local BAs "
          f"{lba.calls}; phases (s) {json.dumps({k: round(v, 4) for k, v in fe.timings.items()})}",
          flush=True)
    checks.record("frontend ran a pose optimization and a 6-keyframe local BA", 0.0, 0.0,
                  ok=po.calls >= 1 and lba.calls >= 1 and lba.args[0].shape[0] == 6)

    p_card = po.fn(*po.args, **po.kw)
    p_cpu = po.fn(*_to_cpu(torch, po.args), **_to_cpu(torch, po.kw))
    err_po = float((p_card.T_cw.cpu() - p_cpu.T_cw).abs().max())
    checks.record(f"pose_optimization card vs CPU ({po.args[1].shape[0]} matches; T max abs)",
                  err_po, 1e-4)
    checks.record("pose_optimization inliers card == CPU", 0.0, 0.0,
                  ok=bool(torch.equal(p_card.inliers.cpu(), p_cpu.inliers)))
    l_card = lba.fn(*lba.args, **lba.kw)
    l_card2 = lba.fn(*lba.args, **lba.kw)
    l_cpu = lba.fn(*_to_cpu(torch, lba.args), **_to_cpu(torch, lba.kw))
    n_obs = lba.args[2].shape[0]
    err_lp = float((l_card.poses.cpu() - l_cpu.poses).abs().max())
    err_lx = float((l_card.points.cpu() - l_cpu.points).abs().max())
    checks.record(f"local_bundle_adjustment card vs CPU poses ({n_obs} observations, max abs)",
                  err_lp, 1e-4)
    checks.record("local_bundle_adjustment card vs CPU points (m, max abs)", err_lx, 1e-4)
    flips = int((l_card.inlier_obs.cpu() != l_cpu.inlier_obs).sum())
    checks.record("local_bundle_adjustment inlier observations differing card vs CPU", flips, 0)
    checks.record("local_bundle_adjustment two card runs bitwise equal (no atomics)", 0.0, 0.0,
                  ok=bool(torch.equal(l_card.poses, l_card2.poses)
                          and torch.equal(l_card.points, l_card2.points)
                          and torch.equal(l_card.inlier_obs, l_card2.inlier_obs)))

    t = {
        "extract_orb": wall_ms(lambda: orb.extract_orb(g0, ocfg), dev, 3),
        "extract (undistort + quad-tree)": wall_ms(lambda: fe._extract(g0), dev, 3),
        "hamming_matrix 1000 x 1000": wall_ms(
            lambda: matcher.hamming_matrix(f_card.descriptors, f1.descriptors), dev, 10),
        f"search_by_projection ({sbp.args[0].shape[0]} points)": wall_ms(
            lambda: sbp.fn(*sbp.args, **sbp.kw), dev, 5),
        f"pose_optimization ({po.args[1].shape[0]} matches)": wall_ms(
            lambda: po.fn(*po.args, **po.kw), dev, 3),
        f"local_bundle_adjustment 6 keyframes ({n_obs} observations)": wall_ms(
            lambda: lba.fn(*lba.args, **lba.kw), dev, 1),
    }
    for name, ms in t.items():
        print(f"# frontend {name}: {ms:.3f} ms (wall, to a synchronize)", flush=True)
    return {"frames": frames, "ms": t}


def phase_orb_system(torch, checks, dev, frames) -> dict:
    """Phase 22: ``System(frontend="orb")`` with TUM1 (distortion, loop
    closing on the packaged vocabulary) over the distorted sequence's first
    frames."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.eval.evaluate import evaluate_sequence
    from gsorb_slam_tpu_torch.interop import system_config_from_dict
    from gsorb_slam_tpu_torch.slam.system import System
    from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES

    cfg = system_config_from_dict(TUM1)
    raster = System.default_raster_config(TUM1["Camera"]["width"])
    phases = ("frontend", "kf", "track", "map")

    def run(n, snapshot_at=None):
        system = System(cfg, raster=raster, seed=0, device=dev, frontend="orb")
        rows, snap = [], None
        for i, fr in enumerate(frames[:n]):
            tm = dict(system.timings)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            system.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
            torch.cuda.synchronize()
            rows.append([time.perf_counter() - t1]
                        + [system.timings[k] - tm[k] for k in phases])
            if i + 1 == snapshot_at:
                snap = ({k: getattr(system.gm, k).clone() for k in PARAM_NAMES},
                        system.fe.pt_pos.copy())
        return system, np.asarray(rows), snap

    torch.cuda.synchronize()
    _build.reset_launches()
    system, rows, snap = run(ORB_SYS_FRAMES, snapshot_at=SYS_RERUN_FRAMES)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    checks.record("ORB System has a loop closer with the packaged vocabulary", 0.0, 0.0,
                  ok=system.loop_closer is not None and system.fe is not None
                  and not system.fe.dist.is_zero())
    mcfg = system.cfg.mapping
    n_track = sum(r.track_iters for r in system.trajectory[1:])
    n_map = mcfg.init_iters + mcfg.num_iters * (ORB_SYS_FRAMES - 1)
    print(f"# ORB System launches: {json.dumps(launches)}", flush=True)
    for name, want in (("fused_track_fast", n_track), ("preprocess_fwd", n_track),
                       ("preprocess_bwd", n_track), ("blend_flat_fwd", n_map),
                       ("blend_flat_bwd", n_map), ("fused_track_exact", 0), ("paired_track", 0)):
        checks.record(f"ORB System {name} launches == {want}", launches[name], want,
                      ok=launches[name] == want)
    checks.record(f"ORB System blend_forward launches == {ORB_SYS_FRAMES - 1}",
                  launches["blend_forward"], ORB_SYS_FRAMES - 1,
                  ok=launches["blend_forward"] == ORB_SYS_FRAMES - 1)
    result = evaluate_sequence(system, frames[:ORB_SYS_FRAMES], stride=1)
    print(f"# ORB System evaluation: {json.dumps(result)}", flush=True)
    checks.record("ORB System ATE RMSE (m, Horn-aligned)", result["ate_rmse"], 0.02)
    checks.record("ORB System PSNR (dB, at least)", result["psnr"], 18.0,
                  ok=result["psnr"] >= 18.0)
    fe = system.fe
    print(f"# ORB System: keyframes {[r.frame_id for r in system.trajectory if r.is_keyframe]}; "
          f"tracking iterations {[r.track_iters for r in system.trajectory]}; map points "
          f"{int(fe.pt_valid.sum())}; frontend keyframes {len(fe.keyframes)}; loop events "
          f"{system.loop_events}", flush=True)
    tracked = rows[1:]
    med = {k: float(np.median(tracked[:, i + 1])) for i, k in enumerate(phases)}
    split = {"frame_s_median": float(np.median(tracked[:, 0])), **{f"{k}_s": v
                                                                   for k, v in med.items()},
             "frame0_s": float(rows[0, 0]),
             "ate_rmse_m": result["ate_rmse"], "psnr_db": result["psnr"]}
    split["frontend_share"] = med["frontend"] / split["frame_s_median"]
    print(f"# ORB System frame split (medians over frames 1-{ORB_SYS_FRAMES - 1}): "
          f"{json.dumps(split)}", flush=True)
    print(f"# ORB System frame rows (s: wall, {', '.join(phases)}): "
          f"{json.dumps([[round(v, 4) for v in r] for r in rows.tolist()])}", flush=True)
    n_fe = ORB_SYS_FRAMES - 1
    print(f"# GeometricFrontend.timings (ms per frame over {n_fe} frames): "
          f"{json.dumps({k: round(v / n_fe * 1e3, 3) for k, v in fe.timings.items()})}",
          flush=True)

    system2, _, _ = run(SYS_RERUN_FRAMES)
    same = all(np.array_equal(a.T_cw, b.T_cw) for a, b in zip(
        system2.trajectory, system.trajectory[:SYS_RERUN_FRAMES]))
    same &= all(torch.equal(getattr(system2.gm, k), snap[0][k]) for k in PARAM_NAMES)
    same &= np.array_equal(system2.fe.pt_pos, snap[1])
    checks.record(f"ORB System rerun of {SYS_RERUN_FRAMES} frames bitwise equal (poses, splat "
                  "map, map points)", 0.0, 0.0, ok=same)
    return {"split": split, "launches": launches}


def phase_loop(torch, checks, dev) -> dict:
    """Phase 23: loop closing on the card, on tests/test_loop_e2e.py's
    scene: a revisiting trajectory with poses injected under accumulating
    drift; the loop must fire and pull the late keyframes closer to the
    ground truth than 0.7x the injected drift."""
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import (
        CameraConfig,
        MappingConfig,
        ORBConfig,
        SystemConfig,
        TrackingConfig,
    )
    from gsorb_slam_tpu_torch.frontend.vocab import default_vocabulary
    from gsorb_slam_tpu_torch.raster import RasterConfig
    from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset
    from gsorb_slam_tpu_torch.slam.system import System

    xs = list(np.arange(0.0, 1.6, 0.2)) + [1.1, 0.7, 0.35, 0.1] + [0.015, 0.0, 0.012, 0.005]
    traj = []
    for i, x in enumerate(xs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -x
        T[1, 3] = 0.01 * np.sin(i)
        traj.append(T)

    def drift(i):
        ang = 0.003 * i
        T = np.eye(4, dtype=np.float32)
        T[0, 0], T[0, 2], T[2, 0], T[2, 2] = np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang)
        T[0, 3], T[1, 3] = 0.009 * i, 0.003 * i
        return T

    cam = Camera(**LOOP_CAM)
    cfg = SystemConfig(
        camera=CameraConfig(**LOOP_CAM, fps=10), orb=ORBConfig(n_features=300, n_levels=3),
        mapping=MappingConfig(num_iters=8, init_iters=10, max_gaussians=16384, window_size=3,
                              covis_window=2),
        tracking=TrackingConfig(num_iters=4, lost_num_iters=4))
    ds = SyntheticDataset(cam, n_splats=3000, seed=5, trajectory=traj, device=dev)
    system = System(cfg, max_keyframes=32, frontend="orb", vocabulary=default_vocabulary(),
                    raster=RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128,
                                        dilate_px=8.0), device=dev)
    lc = system.loop_closer
    lc.min_gap, lc.min_inliers = 8, 12
    system.max_frames_between_kf = 1
    spent = {"verify": 0.0, "correct": 0.0, "global_ba": 0.0, "close": 0.0}

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent[key] += time.perf_counter() - t1

        setattr(obj, name, wrapped)

    timed(lc, "verify", "verify")
    timed(lc, "correct", "correct")
    timed(system.fe, "global_ba", "global_ba")
    close = system._maybe_close_loop
    close_s = []

    def maybe_close(kf):
        n0 = len(system.loop_events)
        t1 = time.perf_counter()
        close(kf)
        torch.cuda.synchronize()
        if len(system.loop_events) > n0:
            close_s.append(time.perf_counter() - t1)

    system._maybe_close_loop = maybe_close
    injected = {}
    for i, fr in enumerate(ds):
        injected[i] = (fr.gt_T_cw @ np.linalg.inv(drift(i))).astype(np.float32)
        system.track_rgbd(fr.rgb, fr.depth, fr.timestamp, gt_pose=injected[i])
    err_inj, err_corr = [], []
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]
    for kf in system.fe.keyframes:
        if kf.frame_id >= len(traj) // 2:
            c_gt = centre(traj[kf.frame_id])
            err_inj.append(np.linalg.norm(centre(injected[kf.frame_id]) - c_gt))
            err_corr.append(np.linalg.norm(centre(np.asarray(kf.T_cw)) - c_gt))
    print(f"# loop closing: {len(system.fe.keyframes)} keyframes, loop events "
          f"{system.loop_events}; late keyframes' centre error corrected "
          f"{np.mean(err_corr) if err_corr else float('nan'):.4f} m against injected "
          f"{np.mean(err_inj) if err_inj else float('nan'):.4f} m", flush=True)
    checks.record("loop closing fired on the revisit", len(system.loop_events), 1,
                  ok=len(system.loop_events) >= 1)
    ratio = float(np.mean(err_corr) / np.mean(err_inj)) if err_corr else float("inf")
    checks.record("loop-corrected late keyframe error / injected drift", ratio, 0.7,
                  ok=ratio < 0.7)
    out = {"closure_s": close_s, **{f"{k}_s": v for k, v in spent.items() if k != "close"}}
    print(f"# loop closure time (s, verify + correct + fuse + global BA): {json.dumps(out)}",
          flush=True)
    return {**out, "events": system.loop_events}

# ------------------------------------------------------- stereo and mono

# Phase 24: rectified VGA pairs of one generated scene (TUM1's camera, the
# baseline bf / fx), the System over its first frames, then a rerun.
STEREO_SEQ_FRAMES = 30
STEREO_FRAMES = 6
STEREO_RERUN_FRAMES = 4
STEREO_SPLATS = 20_000
# Phase 25: the VGA version of configs/synthetic_mono.yaml's scene; the
# reruns go this many frames past the bootstrap.
MONO_FRAMES = 12
MONO_RERUN_FRAMES = 3
# Phase 27: the stereo frames written in the KITTI layout, and run_mono's
# synthetic run length.
KITTI_FRAMES = 3
MONO_APP_FRAMES = 8
# TUM1 for a rectified pair or an undistorted generated sequence: the lens
# distortion is zero (rectification removes it; the generators render none).
TUM1_RECT = {**TUM1, "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0,
             "Camera.p2": 0.0, "Camera.k3": 0.0}
# configs/synthetic_mono.yaml as a dict (the card's machine has no PyYAML).
SYNTH_MONO = {
    "Dataset": {"name": "synthetic_mono_smoke", "type": "synthetic", "path": ""},
    "Camera": {"width": 160, "height": 120, "fx": 130.0, "fy": 130.0, "cx": 80.0, "cy": 60.0,
               "fps": 10.0},
    "ORBextractor": {"nFeatures": 400, "nLevels": 3},
    "Mapping": {"numIters": 15, "maxGaussians": 16384},
    "Tracking": {"numIters": 20},
    "Evalution": {"enable": True, "savePly": False, "saveRootPath": "experiments"},
}


def _tum1_camera(cfg):
    from gsorb_slam_tpu_torch.core.camera import Camera

    cc = cfg.camera
    return Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)


def phase_stereo_system(torch, checks, dev) -> dict:
    """Phase 24: ``System(frontend="orb").track_stereo`` with TUM1 (loop
    closing on the packaged vocabulary) over the first frames of rectified
    VGA pairs: SGBM depth on the host, ORB matches along the rows, then the
    RGB-D path (K1, K2f, K2b, K3, K4, K5)."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.eval.evaluate import evaluate_sequence
    from gsorb_slam_tpu_torch.interop import system_config_from_dict
    from gsorb_slam_tpu_torch.slam import system as SM
    from gsorb_slam_tpu_torch.slam.dataset import RGBDFrame, StereoSyntheticDataset
    from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES

    cfg = system_config_from_dict(TUM1_RECT)
    cc = cfg.camera
    t0 = time.perf_counter()
    ds = StereoSyntheticDataset(_tum1_camera(cfg), cc.bf / cc.fx, n_frames=STEREO_SEQ_FRAMES,
                                n_splats=STEREO_SPLATS, seed=0, motion_scale=0.3, device=dev)
    frames = [ds[i] for i in range(STEREO_FRAMES)]
    moves = [np.linalg.norm(np.linalg.inv(b.gt_T_cw)[:3, 3] - np.linalg.inv(a.gt_T_cw)[:3, 3])
             for a, b in zip(frames[:-1], frames[1:])]
    print(f"# phase 24: {STEREO_SEQ_FRAMES} rectified {cc.width}x{cc.height} pairs of "
          f"{STEREO_SPLATS} splats, baseline {cc.bf / cc.fx * 100:.2f} cm (bf {cc.bf}), "
          f"generated in {time.perf_counter() - t0:.2f} s; the first {STEREO_FRAMES} move "
          f"{np.mean(moves) * 100:.2f} cm per frame", flush=True)
    raster = SM.System.default_raster_config(cc.width)
    phases = ("frontend", "kf", "track", "map")

    def run(n, aux=None, snapshot_at=None):
        system = SM.System(cfg, raster=raster, seed=0, device=dev, frontend="orb")
        if aux is not None:
            track = system.track_rgbd

            def spy(rgb, depth, timestamp=0.0, stereo_aux=None, **kw):
                aux.append((stereo_aux, depth))
                return track(rgb, depth, timestamp, stereo_aux=stereo_aux, **kw)

            system.track_rgbd = spy
        rows, snap = [], None
        for i, fr in enumerate(frames[:n]):
            tm = dict(system.timings)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            system.track_stereo(fr.left, fr.right, fr.timestamp)
            torch.cuda.synchronize()
            rows.append([time.perf_counter() - t1]
                        + [system.timings[k] - tm[k] for k in phases])
            if i + 1 == snapshot_at:
                snap = ({k: getattr(system.gm, k).clone() for k in PARAM_NAMES},
                        system.fe.pt_pos.copy())
        return system, np.asarray(rows), snap

    aux = []
    torch.cuda.synchronize()
    _build.reset_launches()
    with _Capture(SM, "compute_stereo_matches") as csm:
        system, rows, snap = run(STEREO_FRAMES, aux, snapshot_at=STEREO_RERUN_FRAMES)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    n_valid = [int((a["kp_ur"] >= 0).sum()) if a is not None else 0 for a, _ in aux]
    print(f"# stereo System: valid stereo matches per frame {n_valid} of "
          f"{[int(a['feats'].valid.sum()) if a is not None else 0 for a, _ in aux]} keypoints; "
          f"SGBM depth on {[round(float((d > 0).mean()), 4) for _, d in aux]} of the pixels; "
          f"launches {json.dumps(launches)}", flush=True)
    checks.record("stereo System: stereo_aux on every frame with valid stereo matches", 0.0, 0.0,
                  ok=len(aux) == STEREO_FRAMES and min(n_valid) > 0
                  and csm.calls == STEREO_FRAMES)
    mcfg = system.cfg.mapping
    n_track = sum(r.track_iters for r in system.trajectory[1:])
    n_map = mcfg.init_iters + mcfg.num_iters * (STEREO_FRAMES - 1)
    for name, want in (("fused_track_fast", n_track), ("preprocess_fwd", n_track),
                       ("preprocess_bwd", n_track), ("blend_flat_fwd", n_map),
                       ("blend_flat_bwd", n_map), ("blend_forward", STEREO_FRAMES - 1),
                       ("fused_track_exact", 0), ("paired_track", 0)):
        checks.record(f"stereo System {name} launches == {want}", launches[name], want,
                      ok=launches[name] == want and (want > 0 or name in ("fused_track_exact",
                                                                          "paired_track")))
    # Scored as the RGB-D System is, against its sensor images: the left
    # view and the SGBM depth (its mask leaves out the pixels without one).
    seen = [RGBDFrame(fr.timestamp, fr.left, d, fr.gt_T_cw) for fr, (_, d) in zip(frames, aux)]
    result = evaluate_sequence(system, seen, stride=1)
    truth = evaluate_sequence(system, [ds._left[i] for i in range(STEREO_FRAMES)], stride=1)
    print(f"# stereo System evaluation (against the left views and the SGBM depth): "
          f"{json.dumps(result)}; against the rendered depth, every pixel: PSNR "
          f"{truth['psnr']:.3f} dB, depth L1 {truth['depth_l1']:.5f} m", flush=True)
    checks.record("stereo System ATE RMSE (m, Horn-aligned)", result["ate_rmse"], 0.05)
    checks.record("stereo System PSNR (dB, at least)", result["psnr"], 18.0,
                  ok=result["psnr"] >= 18.0)
    print(f"# stereo System: keyframes {[r.frame_id for r in system.trajectory if r.is_keyframe]}; "
          f"tracking iterations {[r.track_iters for r in system.trajectory]}; map points "
          f"{int(system.fe.pt_valid.sum())}; splats {int(system.gm.n_active())}", flush=True)
    tracked = rows[1:]
    med = {k: float(np.median(tracked[:, i + 1])) for i, k in enumerate(phases)}
    split = {"frame_s_median": float(np.median(tracked[:, 0])),
             **{f"{k}_s": v for k, v in med.items()},
             "rest_s": float(np.median(tracked[:, 0] - tracked[:, 1:].sum(1))),
             "frame0_s": float(rows[0, 0]), "ate_rmse_m": result["ate_rmse"],
             "psnr_db": result["psnr"], "depth_l1_m": result["depth_l1"]}
    print(f"# stereo System frame split (medians over frames 1-{STEREO_FRAMES - 1}; rest = "
          f"SGBM, the two extractions, the row matching and the System's own rest): "
          f"{json.dumps(split)}", flush=True)
    print(f"# stereo System frame rows (s: wall, {', '.join(phases)}): "
          f"{json.dumps([[round(v, 4) for v in r] for r in rows.tolist()])}", flush=True)

    system2, _, _ = run(STEREO_RERUN_FRAMES)
    same = all(np.array_equal(a.T_cw, b.T_cw) for a, b in zip(
        system2.trajectory, system.trajectory[:STEREO_RERUN_FRAMES]))
    same &= all(torch.equal(getattr(system2.gm, k), snap[0][k]) for k in PARAM_NAMES)
    same &= np.array_equal(system2.fe.pt_pos, snap[1])
    checks.record(f"stereo System rerun of {STEREO_RERUN_FRAMES} frames bitwise equal (poses, "
                  "splat map, map points)", 0.0, 0.0, ok=same)
    return {"launches": launches, "split": split, "frames": frames,
            "matches": (csm.fn, csm.args, csm.kw)}


def phase_mono_system(torch, checks, dev) -> dict:
    """Phase 25: ``System(frontend="orb").track_monocular`` with TUM1's camera
    and ORB settings (loop closing on, the JAX app's bootstrap gates 40 /
    30) over the VGA version of ``configs/synthetic_mono.yaml``'s scene:
    the bootstrap, tracking, LOST after 2 blank frames and relocalization
    after a jump back; a short run that resets itself; a 4-frame rerun.
    The monocular path launches no kernel."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.interop import system_config_from_dict
    from gsorb_slam_tpu_torch.slam import system as SM
    from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset
    from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES

    cfg = system_config_from_dict(TUM1_RECT)
    t0 = time.perf_counter()
    ds = SyntheticDataset(_tum1_camera(cfg), n_frames=MONO_FRAMES, n_splats=6000, seed=7,
                          motion_scale=0.35, scale_range=(0.02, 0.05), device=dev)
    frames = [ds[i] for i in range(MONO_FRAMES)]
    print(f"# phase 25: {MONO_FRAMES} monocular frames of {cfg.camera.width}x"
          f"{cfg.camera.height} generated in {time.perf_counter() - t0:.2f} s", flush=True)
    blank = np.zeros_like(frames[0].rgb)
    init_calls = []
    init = SM.initialize_monocular

    def recorded_init(*a, **kw):
        res = init(*a, **kw)
        if res is not None:
            init_calls.append((a, kw, res))
        return res

    def make():
        return SM.System(cfg, seed=0, device=dev, frontend="orb", mono_min_matches=40,
                         mono_min_inliers=30)

    def run(system, seq, t_offset=0.0):
        out, walls = [], []
        for i, fr in enumerate(seq):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out.append(system.track_monocular(fr.rgb, t_offset + fr.timestamp))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        return out, walls

    torch.cuda.synchronize()
    _build.reset_launches()
    SM.initialize_monocular = recorded_init
    try:
        system = make()
        poses, walls = run(system, frames)
    finally:
        SM.initialize_monocular = init
    fe = system.fe
    booted = [T is not None for T in poses]
    first = booted.index(True) if any(booted) else -1
    init_args, init_kw, res0 = init_calls[0] if init_calls else ((), {}, None)
    print(f"# mono System: bootstrap at frame {first} ({res0.model if res0 else '-'} model, "
          f"{int(res0.inliers.sum()) if res0 else 0} points from "
          f"{len(init_args[0]) if init_args else 0} matches); "
          f"ORB inliers per frame {[r.track_iters for r in system.trajectory]}; map points "
          f"{fe.n_points}, frontend keyframes {len(fe.keyframes)}, splats "
          f"{int(system.gm.n_active())}", flush=True)
    checks.record("mono System bootstrapped, every later frame has a pose", 0.0, 0.0,
                  ok=first >= 0 and all(booted[first:]))
    checks.record("mono System map points (at least)", fe.n_points, 25, ok=fe.n_points > 25)
    checks.record("mono System splat map seeded (at least)", int(system.gm.n_active()), 25,
                  ok=int(system.gm.n_active()) > 25)
    checks.record("mono System loop closer solves the scale (fix_scale False)", 0.0, 0.0,
                  ok=system.loop_closer is not None and system.loop_closer.fix_scale is False)
    tracked = np.asarray(walls[first + 1:]) if first >= 0 else np.asarray(walls)
    e2e = {"frame_s_median": float(np.median(tracked)), "frame_s_max": float(tracked.max()),
           "bootstrap_frame_s": float(walls[first]) if first >= 0 else None,
           "frame0_s": float(walls[0])}
    print(f"# mono System frame times (s, tracked frames after the bootstrap): "
          f"{json.dumps(e2e)}; all {json.dumps([round(w, 4) for w in walls])}", flush=True)

    # LOST after a blackout, relocalized after a jump back to one of the
    # first frames after the bootstrap (tests/test_sensors.py jumps to frames
    # 2-4, where its smaller scene has bootstrapped at frame 1).
    for j in range(2):
        system.track_monocular(blank, 100.0 + j)
    lost = system._mono_state == "LOST"
    recovered = None
    for k in range(first + 1, min(first + 4, MONO_FRAMES)):
        T = system.track_monocular(frames[k].rgb, 200.0 + k)
        if system._mono_state == "OK" and T is not None and poses[k] is not None:
            err = float(np.linalg.norm(T[:3, 3] - poses[k][:3, 3]))
            recovered = (k, err, max(float(np.linalg.norm(poses[k][:3, 3])), 0.2))
            break
    print(f"# mono System: LOST after 2 blank frames {lost}; relocalized (frame, error, "
          f"scale) {recovered}", flush=True)
    checks.record("mono System LOST after 2 blank frames", 0.0, 0.0, ok=lost)
    checks.record("mono System relocalized after the jump back (error / scale)",
                  recovered[1] / recovered[2] if recovered else math.inf, 0.5)

    # A young map lost for 3 frames resets itself and bootstraps again.
    short = make()
    seq = frames[:max(first, 1) + 2]
    run(short, seq)
    booted_short = short._mono_initialized
    run(short, [dataclasses.replace(frames[0], rgb=blank)] * 4, 100.0)
    was_reset = not short._mono_initialized and short._mono_state == "NOT_INITIALIZED"
    run(short, seq, 200.0)
    checks.record("mono System auto-reset when lost with a young map, then bootstraps again",
                  0.0, 0.0, ok=booted_short and was_reset and short._mono_initialized)

    # Two more Systems over the frames up to 3 past the bootstrap.
    n_rerun = max(first, 0) + MONO_RERUN_FRAMES
    again = make()
    poses2, _ = run(again, frames[:n_rerun])
    ref = make()
    poses_ref, _ = run(ref, frames[:n_rerun])
    same = all((a is None and b is None) or (a is not None and b is not None
                                             and np.array_equal(a, b))
               for a, b in zip(poses2, poses_ref))
    same &= all((a is None and b is None) or np.array_equal(a, b)
                for a, b in zip(poses2, poses[:n_rerun]))
    same &= np.array_equal(again.fe.pt_pos, ref.fe.pt_pos)
    same &= all(torch.equal(getattr(again.gm, k), getattr(ref.gm, k)) for k in PARAM_NAMES)
    checks.record(f"mono System rerun of {n_rerun} frames bitwise equal (poses, map points, "
                  "splat map)", 0.0, 0.0, ok=same)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    checks.record("mono phase launched no kernel (K1-K9 = 0)", sum(launches.values()), 0,
                  ok=not any(launches.values()))
    return {"e2e": e2e, "init": (init_args, init_kw, res0), "launches": launches}


def phase_sensor_modules(torch, checks, dev, stereo: dict, mono: dict) -> dict:
    """Phase 26: the stereo matcher on phase 24's last VGA pair and the
    initializer on phase 25's bootstrap, on the card against the CPU."""
    from gsorb_slam_tpu_torch.frontend import initializer as I
    from gsorb_slam_tpu_torch.profiling.common import wall_ms

    fn, args, kw = stereo["matches"]
    card = fn(*args, **kw)
    cpu = fn(*_to_cpu(torch, args), **_to_cpu(torch, kw))
    same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
               for f in ("u_right", "depth", "valid"))
    n_l, n_r = int(args[0].valid.sum()), int(args[1].valid.sum())
    checks.record(f"compute_stereo_matches card == CPU ({n_l} x {n_r} keypoints; u_right, "
                  f"depth, valid)", 0.0, 0.0, ok=same)
    out = {"stereo_matches_ms": wall_ms(lambda: fn(*args, **kw), torch.device(dev), 5),
           "valid_matches": int(card.valid.sum())}

    init_args, init_kw, _ = mono["init"]
    if init_args:
        kw_card = {**init_kw, "device": dev}
        kw_cpu = {**init_kw, "device": "cpu"}
        a = I.initialize_monocular(*init_args, **kw_card)
        b = I.initialize_monocular(*init_args, **kw_card)
        c = I.initialize_monocular(*init_args, **kw_cpu)
        ok = a is not None and c is not None and a.model == c.model
        ok &= ok and np.array_equal(a.inliers, c.inliers)
        err = float(np.abs(a.T_cw2 - c.T_cw2).max()) if ok else math.inf
        checks.record(f"initialize_monocular card vs CPU ({len(init_args[0])} matches): the "
                      "same model and inlier mask", 0.0, 0.0, ok=ok)
        checks.record("initialize_monocular card vs CPU T_cw2 (max abs)", err, 1e-4)
        checks.record("initialize_monocular two card runs bitwise equal", 0.0, 0.0,
                      ok=b is not None and np.array_equal(a.T_cw2, b.T_cw2)
                      and np.array_equal(a.points, b.points)
                      and np.array_equal(a.inliers, b.inliers))
        out["initialize_monocular_ms"] = wall_ms(
            lambda: I.initialize_monocular(*init_args, **kw_card), torch.device(dev), 3)
        out["score_gap_card_cpu"] = _init_score_gaps(torch, I, init_args, dev)
    else:
        checks.record("initialize_monocular card vs CPU: a bootstrap to compare", 0.0, 0.0,
                      ok=False)

    import cv2

    fr = stereo["frames"][-1]
    l8 = cv2.cvtColor((np.asarray(fr.left, np.float32) * 255).astype(np.uint8),
                      cv2.COLOR_RGB2GRAY)
    r8 = cv2.cvtColor((np.asarray(fr.right, np.float32) * 255).astype(np.uint8),
                      cv2.COLOR_RGB2GRAY)
    sgbm = cv2.StereoSGBM_create(minDisparity=0, numDisparities=96, blockSize=7, P1=8 * 49,
                                 P2=32 * 49, uniquenessRatio=10)
    t0 = time.perf_counter()
    for _ in range(3):
        sgbm.compute(l8, r8)
    out["sgbm_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    print(f"# sensor modules (wall, to a synchronize; SGBM on the host): {json.dumps(out)}",
          flush=True)
    return out


def _init_score_gaps(torch, I, init_args, dev) -> dict:
    """The largest gap between the card's and the CPU's score of one F / H
    hypothesis of the bootstrap, over the samples with distinct points and
    over those that repeat one (before ``_drop_repeats``): a repeat leaves
    a null space of two or more dimensions, and each SVD returns another
    vector of it."""
    from gsorb_slam_tpu_torch.frontend import draws

    uv1, uv2 = init_args[0], init_args[1]
    draw_f, draw_h = draws.draw_index_sets(0, [(200, 8), (200, 4)], len(uv1))
    scores = {}
    for d in (dev, "cpu"):
        p1, p2 = (torch.as_tensor(np.asarray(a, np.float32), device=d) for a in (uv1, uv2))
        (n1, T1), (n2, T2) = I._normalize(p1), I._normalize(p2)
        f, h = (torch.as_tensor(np.array(x), device=d) for x in (draw_f, draw_h))
        F = T2.T @ I.compute_f_batch(n1[f], n2[f]) @ T1
        H = torch.linalg.inv(T2) @ I.compute_h_batch(n1[h], n2[h]) @ T1
        scores[d] = (I.score_f(F, p1, p2)[0].cpu().numpy(), I.score_h(H, p1, p2)[0].cpu().numpy())
    out = {}
    for k, (name, draw) in enumerate((("F", draw_f), ("H", draw_h))):
        srt = np.sort(draw, axis=1)
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
        gap = np.abs(scores[dev][k] - scores["cpu"][k])
        out[name] = {"distinct": float(gap[distinct].max()),
                     "repeats": float(gap[~distinct].max()) if (~distinct).any() else None,
                     "n_repeats": int((~distinct).sum())}
    return out


def phase_sensor_apps(torch, checks, dev, stereo_frames, tum_dir: str, tmp: str) -> dict:
    """Phase 27: ``run_stereo --type kitti`` over a KITTI layout written from
    phase 24's first frames, ``run_mono --type tum`` over phase 19's TUM
    directory and ``run_mono --type synthetic`` with
    ``configs/synthetic_mono.yaml`` (as ``.json``)."""
    import cv2

    from gsorb_slam_tpu_torch.apps import run_mono, run_stereo

    kitti = os.path.join(tmp, "kitti")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(kitti, sub), exist_ok=True)
    gray = lambda rgb: cv2.cvtColor((np.asarray(rgb, np.float32) * 255).astype(np.uint8),
                                    cv2.COLOR_RGB2GRAY)
    for i, fr in enumerate(stereo_frames[:KITTI_FRAMES]):
        cv2.imwrite(os.path.join(kitti, "image_0", f"{i:06d}.png"), gray(fr.left))
        cv2.imwrite(os.path.join(kitti, "image_1", f"{i:06d}.png"), gray(fr.right))
    with open(os.path.join(kitti, "times.txt"), "w") as f:
        f.write("".join(f"{fr.timestamp:.6e}\n" for fr in stereo_frames[:KITTI_FRAMES]))
    rect = os.path.join(tmp, "tum1_rect.json")
    with open(rect, "w") as f:
        json.dump(TUM1_RECT, f)
    synth = os.path.join(tmp, "synthetic_mono.json")
    with open(synth, "w") as f:
        json.dump(SYNTH_MONO, f)

    results = {}
    for label, mod, argv in (
            ("run_stereo --type kitti", run_stereo,
             ["--config", rect, "--type", "kitti", "--dataset", kitti]),
            ("run_mono --type tum", run_mono, ["--config", rect, "--type", "tum", "--dataset",
                                               tum_dir]),
            ("run_mono --type synthetic", run_mono,
             ["--config", synth, "--type", "synthetic", "--max-frames", str(MONO_APP_FRAMES)])):
        out = os.path.join(tmp, label.replace(" ", "_").replace("-", ""))
        t0 = time.perf_counter()
        rc, _ = _quiet_call(mod.main, argv + ["--out", out])
        secs = time.perf_counter() - t0
        written = all(os.path.exists(os.path.join(out, n)) and os.path.getsize(os.path.join(
            out, n)) > 0 for n in ("CameraTrajectory_TUM.txt", "CameraTrajectory_KITTI.txt"))
        res = {}
        if os.path.exists(os.path.join(out, "result.txt")):
            with open(os.path.join(out, "result.txt")) as f:
                res = json.loads(f.read().splitlines()[-1])
        keep = {k: res.get(k) for k in ("frames_total", "frames_tracked", "median_frame_s",
                                        "n_keyframes", "total_gaussians")}
        print(f"# {label}: exit {rc} in {secs:.1f} s; {json.dumps(keep)}", flush=True)
        checks.record(f"apps: {label} exit 0, both trajectories and result.txt written", 0.0,
                      0.0, ok=rc == 0 and written and res.get("frames_total", 0) > 0)
        results[label] = keep
    return results


# ------------------------------------------------- tools, viewers, entries

VIEWER_FRAMES = 10  # phase 28: the orbit's frames
WEB_REQUESTS = 5  # phase 29: timed splat renders over HTTP
MTD_FRAMES = 3  # phase 35: frames make_tum_disk writes


def _launches_since_reset(torch) -> dict:
    from gsorb_slam_tpu_torch import _build

    torch.cuda.synchronize()
    return dict(_build.launches)


def phase_viewer(torch, checks, dev, disk: dict, tmp: str) -> dict:
    """Phase 28: ``apps.viewer`` over phase 19's PLY (the System's map at
    TUM1's VGA camera) in ``orbit`` mode (VIEWER_FRAMES frames) and along
    phase 19's trajectory in ``replay`` mode: exit 0, one PNG and one K3
    launch per frame, the orbit's frame 0 equal to the 8-bit K3 render of
    its pose, and K3 against the plain blend on that pose."""
    import cv2

    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.apps import viewer
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval.ply import load_gaussian_ply
    from gsorb_slam_tpu_torch.eval.trajectory import load_tum
    from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess
    from gsorb_slam_tpu_torch.raster import render_binned, render_tiled

    launches = {}
    ms = {}
    n_replay = len(load_tum(disk["traj"]))
    for mode, extra, n in (("orbit", ["--frames", str(VIEWER_FRAMES)], VIEWER_FRAMES),
                           ("replay", ["--traj", disk["traj"]], n_replay)):
        out = os.path.join(tmp, f"viewer_{mode}")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rc, _ = _quiet_call(viewer.main, ["--ply", disk["ply"], "--config", disk["cfg_path"],
                                          "--mode", mode, "--out", out] + extra)
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) / n * 1e3
        launches[mode] = dict(_build.launches)
        pngs = sorted(os.listdir(out)) if os.path.isdir(out) else []
        checks.record(f"viewer {mode}: exit 0 and {n} PNGs", len(pngs), n,
                      ok=rc == 0 and pngs == [f"view_{i:04d}.png" for i in range(n)])
        checks.record(f"viewer {mode}: blend_forward launches == {n}",
                      launches[mode]["blend_forward"], n,
                      ok=launches[mode]["blend_forward"] == n)
    # The orbit's frame 0 again: K3 and the plain blend on the same pose.
    model = load_gaussian_ply(disk["ply"])
    p = {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in model.items()}
    cc = load_config(disk["cfg_path"]).camera
    cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
    rcfg = RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128)
    T0 = torch.as_tensor(viewer.orbit_poses(model["means"], VIEWER_FRAMES, 0.5)[0], device=dev)
    with torch.no_grad():
        prep = preprocess(p["means"], p["rgb"], p["quats"], p["logit_opacities"],
                          p["log_scales"], torch.ones(len(model["means"]), dtype=torch.bool,
                                                      device=dev), T0, cam)
        bins = bin_gaussians(prep, cam, rcfg)
        k3 = render_binned(prep, bins, cam, rcfg).color
        plain = render_tiled(prep, bins, cam, rcfg).color
    png = cv2.cvtColor(cv2.imread(os.path.join(tmp, "viewer_orbit", "view_0000.png")),
                       cv2.COLOR_BGR2RGB)
    want = (np.clip(k3.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    checks.record("viewer: orbit frame 0 PNG against the 8-bit K3 render (levels)",
                  float(np.abs(png.astype(np.int64) - want).max()), 0.0)
    checks.record("viewer: K3 against the plain blend on orbit frame 0 (colour)",
                  float((k3 - plain).abs().max()), 2e-3)
    checks.record("viewer: orbit frame 0 is not blank (colour std)", float(k3.std()), 1e-3,
                  ok=float(k3.std()) > 1e-3)
    print(f"# phase 28 viewer: ms per frame (render + PNG write) {json.dumps(ms)} over "
          f"{len(model['means'])} splats at {cc.width}x{cc.height}; launches "
          f"{json.dumps(launches)}", flush=True)
    return {"ms": ms, "launches": [launches["orbit"], launches["replay"]]}


def phase_web_viewer(torch, checks, dev, system) -> dict:
    """Phase 29: ``ViewerServer.from_system`` over phase 19's System, served
    on 127.0.0.1 at an ephemeral port: the page, the state, a ``splat`` and
    a ``map`` render decoding at the camera's size, one K3 launch per splat
    request, and the ms per request."""
    import threading
    import urllib.request
    from http.server import HTTPServer

    import cv2

    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.apps.viewer_web import ViewerServer

    srv = ViewerServer.from_system(system)
    httpd = HTTPServer(("127.0.0.1", 0), srv.handler())
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(state):
        req = urllib.request.Request(url + "/render", data=json.dumps(state).encode(),
                                     method="POST")
        return urllib.request.urlopen(req, timeout=120).read()

    def decode(buf):
        return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)

    W, H = system.cam.width, system.cam.height
    try:
        page = urllib.request.urlopen(url + "/", timeout=60).read()
        state = json.loads(urllib.request.urlopen(url + "/state", timeout=60).read())
        checks.record("web viewer: page and state served", 0.0, 0.0,
                      ok=b"orbit" in page and state["width"] == W and state["mode"] == "splat")
        post(dict(state, yaw=0.2))  # warm
        torch.cuda.synchronize()
        _build.reset_launches()
        shapes, t0 = [], time.perf_counter()
        for i in range(WEB_REQUESTS):
            shapes.append(decode(post(dict(state, yaw=0.1 * i, pitch=0.05 * i))).shape)
        splat_ms = (time.perf_counter() - t0) / WEB_REQUESTS * 1e3
        launches = _launches_since_reset(torch)
        t0 = time.perf_counter()
        img_map = decode(post(dict(state, mode="map")))
        map_ms = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    checks.record(f"web viewer: {WEB_REQUESTS} splat JPEGs decode at {W}x{H}", 0.0, 0.0,
                  ok=all(s == (H, W, 3) for s in shapes))
    checks.record("web viewer: the map JPEG decodes and is drawn", 0.0, 0.0,
                  ok=img_map is not None and img_map.shape == (H, W, 3)
                  and float(img_map.std()) > 1.0)
    checks.record(f"web viewer: blend_forward launches == {WEB_REQUESTS}",
                  launches["blend_forward"], WEB_REQUESTS,
                  ok=launches["blend_forward"] == WEB_REQUESTS)
    print(f"# phase 29 web viewer: ms per request (render, JPEG, HTTP) splat {splat_ms:.2f}, "
          f"map {map_ms:.2f}; launches {json.dumps(launches)}", flush=True)
    return {"splat_ms": splat_ms, "map_ms": map_ms, "launches": [launches]}


def phase_entry(torch, checks, dev) -> dict:
    """Phase 30: ``graft_entry.entry()``: its ``(loss, color)`` through K3
    against the same fn with the plain blend (colour 2e-3 absolute, loss
    1e-3 relative), two calls bitwise, a backward through K6 with finite
    gradients, and the ms of a forward and of a forward and backward."""
    from gsorb_slam_tpu_torch import _build, graft_entry, raster

    fn, args = graft_entry.entry()
    kernel_render = raster.render_binned
    raster.render_binned = raster.render_tiled  # entry() binds its render at the call
    try:
        plain_fn, _ = graft_entry.entry()
    finally:
        raster.render_binned = kernel_render
    torch.cuda.synchronize()
    _build.reset_launches()
    with torch.no_grad():
        loss, color = fn(*args)
        loss2, color2 = fn(*args)
    fwd_launches = _launches_since_reset(torch)
    with torch.no_grad():
        loss_p, color_p = plain_fn(*args)
    checks.record("entry: colour against the plain blend", float((color - color_p).abs().max()),
                  2e-3)
    checks.record("entry: loss against the plain blend (relative)", rel_err(loss, loss_p), 1e-3)
    checks.record("entry: two calls bitwise", 0.0, 0.0,
                  ok=bool(torch.equal(loss, loss2) and torch.equal(color, color2)))
    checks.record("entry: blend_forward launches == 2", fwd_launches["blend_forward"], 2,
                  ok=fwd_launches["blend_forward"] == 2)
    params = [a.detach().clone().requires_grad_(True) for a in args]
    _build.reset_launches()
    fn(*params)[0].backward()
    bwd_launches = _launches_since_reset(torch)
    finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params)
    checks.record("entry: backward through K6 finite", 0.0, 0.0,
                  ok=finite and float(params[0].grad.abs().sum()) > 0)
    checks.record("entry: blend_backward launches == 1", bwd_launches["blend_backward"], 1,
                  ok=bwd_launches["blend_backward"] == 1)

    def fwd_bwd():
        ps = [a.detach().requires_grad_(True) for a in args]
        fn(*ps)[0].backward()

    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: fn(*args), 10)
    fwd_bwd_ms = time_ms(torch, fwd_bwd, 10)
    print(f"# phase 30 entry: loss {float(loss):.4f} (plain {float(loss_p):.4f}), forward "
          f"{fwd_ms:.3f} ms, forward + backward {fwd_bwd_ms:.3f} ms at 320x240, 20,000 splats",
          flush=True)
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
            "launches": [fwd_launches, bwd_launches]}


def phase_dryrun(torch, checks) -> dict:
    """Phase 31: ``graft_entry.dryrun_multichip`` over every card (one rank a
    card, NCCL): finite losses and pose, the ranks equal, one mapping
    ``all_reduce`` and one per tracking iteration, K3 = K6 = 1 and K1 = K2f
    = K2b = 3 launches on each rank; the losses and the pose within 1e-4 of
    the same dry run on the CPU (gloo ranks, the plain versions)."""
    from gsorb_slam_tpu_torch import graft_entry

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    results, _ = _quiet_call(graft_entry.dryrun_multichip, n)
    seconds = time.perf_counter() - t0
    r0 = results[0]
    ok = all(math.isfinite(r["loss"]) and math.isfinite(r["track_loss"])
             and np.isfinite(r["T_cw"]).all() and r["loss"] == r0["loss"]
             and np.array_equal(r["T_cw"], r0["T_cw"]) for r in results)
    checks.record(f"dryrun_multichip({n}): finite losses and pose, ranks equal", 0.0, 0.0, ok=ok)
    cpu, _ = _quiet_call(graft_entry.dryrun_multichip, n, "cpu")  # the plain versions, gloo
    checks.record("dryrun_multichip: mapping loss against the CPU's (relative)",
                  abs(r0["loss"] - cpu[0]["loss"]) / abs(cpu[0]["loss"]), 1e-4)
    checks.record("dryrun_multichip: tracking loss and pose against the CPU's",
                  max(abs(r0["track_loss"] - cpu[0]["track_loss"]),
                      float(np.abs(r0["T_cw"] - cpu[0]["T_cw"]).max())), 1e-4)
    want = {"blend_forward": 1, "blend_backward": 1, "fused_track_fast": 3,
            "preprocess_fwd": 3, "preprocess_bwd": 3}
    for rank, r in enumerate(results):
        checks.record(f"dryrun_multichip: all_reduce calls == 4 (rank {rank})",
                      r["collectives"]["all_reduce"], 4, ok=r["collectives"]["all_reduce"] == 4)
        checks.record(f"dryrun_multichip: launches {json.dumps(want)} (rank {rank})", 0.0, 0.0,
                      ok=all(r["launches"][k] == v for k, v in want.items()))
    print(f"# phase 31 dryrun_multichip({n}) over NCCL: loss {r0['loss']:.4f}, tracking loss "
          f"{r0['track_loss']:.4f}, collectives {json.dumps(r0['collectives'])}, launches "
          f"{json.dumps(r0['launches'])}, {seconds:.1f} s (the ranks' start included)",
          flush=True)
    return {"seconds": seconds, "launches": [r["launches"] for r in results]}


def phase_lpips(torch, checks, dev, system, frame, tmp: str) -> dict:
    """Phase 32: LPIPS with seeded random weights (the real ones are not in
    the repository) written to a temporary ``.npz``, on phase 19's System's
    render of the first frame and its gt at VGA: the card against the CPU
    (1e-4 relative), identical images below 1e-6, ``metrics.lpips`` through
    ``GSORB_LPIPS_WEIGHTS`` equal to ``lpips_pair``, TF32 off, ms per pair."""
    from gsorb_slam_tpu_torch.ops import lpips as LP
    from gsorb_slam_tpu_torch.ops import metrics as MM

    rng = np.random.default_rng(0)
    shapes = [(11, 3, 64), (5, 64, 192), (3, 192, 384), (3, 384, 256), (3, 256, 256)]
    w = {}
    for i, (k, cin, cout) in enumerate(shapes):
        w[f"conv{i}_w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.01, cout).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, cout).astype(np.float32)
    path = os.path.join(tmp, "lpips_alex.npz")
    np.savez(path, **w)
    with torch.no_grad():
        pred = torch.clamp(system.render_view(system.trajectory[0].T_cw).color, 0, 1)
    target = torch.as_tensor(np.asarray(frame.rgb, np.float32), device=dev)
    w_card, w_cpu = LP.load_lpips_weights(path, dev), LP.load_lpips_weights(path, "cpu")
    d_card = float(LP.lpips_pair(pred, target, w_card))
    tf32 = torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
    d_cpu = float(LP.lpips_pair(pred.cpu(), target.cpu(), w_cpu))
    d_same = float(LP.lpips_pair(pred, pred, w_card))
    old = os.environ.get("GSORB_LPIPS_WEIGHTS")
    os.environ["GSORB_LPIPS_WEIGHTS"] = path
    try:
        MM.reset_lpips()
        d_metric = MM.lpips(pred, target)
    finally:
        MM.reset_lpips()
        if old is None:
            del os.environ["GSORB_LPIPS_WEIGHTS"]
        else:
            os.environ["GSORB_LPIPS_WEIGHTS"] = old
    checks.record("lpips: card against the CPU (relative)", abs(d_card - d_cpu) / abs(d_cpu),
                  1e-4, ok=abs(d_card - d_cpu) <= 1e-4 * abs(d_cpu) and d_cpu > 0)
    checks.record("lpips: identical images", abs(d_same), 1e-6)
    checks.record("lpips: metrics.lpips equal to lpips_pair", abs(d_metric - d_card), 0.0)
    checks.record("lpips: TF32 off on the card's convolutions", float(tf32), 0.0)
    ms = time_ms(torch, lambda: LP.lpips_pair(pred, target, w_card), 10)
    print(f"# phase 32 LPIPS (random weights) at {pred.shape[1]}x{pred.shape[0]}: card "
          f"{d_card:.6f}, CPU {d_cpu:.6f}, {ms:.3f} ms per pair", flush=True)
    return {"ms": ms}


def phase_train_vocab(torch, checks, tmp: str) -> dict:
    """Phase 33: ``scripts.train_vocab`` on the card into a temporary
    ``--out``: exit 0, the file loads back with the trained word count, and
    how many of the packaged vocabulary's node descriptors it reproduces
    (recorded: descriptors on the card may differ from the CPU's on a few
    rows); its seconds."""
    from gsorb_slam_tpu_torch.frontend.vocab import default_vocabulary, load_orbvoc_text
    from gsorb_slam_tpu_torch.scripts import train_vocab

    out = os.path.join(tmp, "ORBvoc_card.txt")
    t0 = time.perf_counter()
    rc, text = _quiet_call(train_vocab.main, ["--out", out])
    seconds = time.perf_counter() - t0
    voc = load_orbvoc_text(out) if rc == 0 else None
    trained = int(text.split("vocabulary: ")[1].split()[0]) if "vocabulary: " in text else -1
    checks.record("train_vocab: exit 0, the file loads with its word count", 0.0, 0.0,
                  ok=voc is not None and voc.n_words == trained > 0)
    ref = default_vocabulary()
    same = 0.0
    if voc is not None:
        n = min(len(voc.node_desc), len(ref.node_desc))
        same = float((voc.node_desc[:n] == ref.node_desc[:n]).all(1).mean())
    print(f"# phase 33 train_vocab on the card: {trained} words (packaged {ref.n_words}), "
          f"{same:.4f} of the node descriptors equal to the packaged file's, {seconds:.1f} s",
          flush=True)
    return {"seconds": seconds, "n_words": trained, "same": same}


def phase_debug_loop(torch, checks, loop_events) -> dict:
    """Phase 34: ``scripts.debug_loop``'s ``main`` on the card: exit 0, the
    verify diagnostics printed, and the loop fires with phase 23's events
    (the same scene and settings)."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.scripts import debug_loop

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rc, text = _quiet_call(debug_loop.main, [])
    seconds = time.perf_counter() - t0
    launches = _launches_since_reset(torch)
    events = [ln for ln in text.splitlines() if ln.startswith("loop_events:")]
    fired = events[-1].split(":", 1)[1].strip() if events else ""
    checks.record("debug_loop: exit 0 and verify's diagnostics printed", 0.0, 0.0,
                  ok=rc == 0 and "bow_matches=" in text and "ransac_inliers=" in text)
    checks.record("debug_loop: the loop fires as in phase 23", 0.0, 0.0,
                  ok=fired not in ("", "[]") and fired == str(loop_events))
    print(f"# phase 34 debug_loop: loop events {fired} (phase 23: {loop_events}), "
          f"{seconds:.1f} s; launches {json.dumps(launches)}; its probe: "
          + " | ".join(ln for ln in text.splitlines() if ln.startswith("probe")), flush=True)
    return {"seconds": seconds, "launches": [launches]}


def phase_disk_tools(torch, checks, tmp: str) -> dict:
    """Phase 35: ``scripts.make_tum_disk`` writes MTD_FRAMES TUM-like VGA
    frames generated on the card in the TUM and the ScanNet layouts (one
    render cache), ``slam.dataset`` reads them back; ``scripts.pose2traj``
    turns the ScanNet poses into ``groundtruth.txt`` rows equal to them."""
    from gsorb_slam_tpu_torch.scripts import make_tum_disk, pose2traj
    from gsorb_slam_tpu_torch.slam import dataset as D

    cache = os.path.join(tmp, "mtd_cache")
    roots = {f: os.path.join(tmp, f"mtd_{f}") for f in ("tum", "scannet")}
    t0 = time.perf_counter()
    rcs = [_quiet_call(make_tum_disk.main, ["--out", roots[f], "--frames", str(MTD_FRAMES),
                                            "--format", f, "--cache-dir", cache])[0]
           for f in roots]
    seconds = time.perf_counter() - t0
    tum = D.open_dataset("tum", roots["tum"], 5000.0)
    scan = D.open_dataset("scannet", roots["scannet"], 5000.0)
    ok = rcs == [0, 0] and len(tum) == len(scan) == MTD_FRAMES
    for ds in (tum, scan):
        for i in range(len(ds)):
            fr = ds[i]
            ok &= fr.rgb.shape == (480, 640, 3) and bool((fr.depth > 0).mean() > 0.5)
            ok &= fr.gt_T_cw is not None and bool(np.isfinite(fr.gt_T_cw).all())
    checks.record(f"make_tum_disk: {MTD_FRAMES} VGA frames read back in both layouts", 0.0, 0.0,
                  ok=ok)
    rc, _ = _quiet_call(pose2traj.main, [roots["scannet"]])
    rows = np.loadtxt(os.path.join(roots["scannet"], "groundtruth.txt"), ndmin=2)
    err = max(float(np.abs(rows[i, 1:].reshape(4, 4)
                           - np.loadtxt(os.path.join(roots["scannet"], "pose", f"{i}.txt"))).max())
              for i in range(MTD_FRAMES)) if rows.shape[0] == MTD_FRAMES else math.inf
    checks.record("pose2traj: groundtruth.txt rows against the pose files", err, 1e-6,
                  ok=rc == 0 and err <= 1e-6)
    print(f"# phase 35 make_tum_disk: {MTD_FRAMES} TUM-like VGA frames in two layouts "
          f"{seconds:.1f} s; pose2traj wrote {rows.shape[0]} rows", flush=True)
    return {"seconds": seconds}


def profile_call(torch, fn, best_s: float, what: str) -> dict | None:
    """One call of ``fn`` under torch.profiler (``profiling.common.profile_call``):
    the kernels' device time and launches, its share of the profiled call's
    wall time and of the best unprofiled call's, and the kernels that take
    the most. Returns the profile (None where no device time was seen)."""
    from gsorb_slam_tpu_torch.profiling.common import profile_call as profiled, profile_lines

    prof = profiled(fn, torch.device(DEVICE), best_s * 1e3)
    for line in profile_lines(prof, what):
        print(line, flush=True)
    return prof


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import TrackingConfig
    from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix, rotmat_to_quat
    from gsorb_slam_tpu_torch.raster import (
        RasterConfig,
        bin_gaussians,
        preprocess,
        render,
        render_binned,
    )
    from gsorb_slam_tpu_torch.raster.binning import tile_grid_shape
    from gsorb_slam_tpu_torch.raster.blend_kernels import (
        blend_backward,
        blend_backward_plain,
        blend_forward,
        blend_forward_plain,
        footprint_keep,
        gt_without_loss_edges,
        pack_instances,
        tile_gt_images,
        tile_pixels,
        tracking_blend,
        tracking_loss_grad,
        tracking_loss_grad_plain,
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
    from gsorb_slam_tpu_torch.raster.flat_kernels import (
        blend_flat_backward,
        blend_flat_backward_plain,
        blend_flat_forward,
        blend_flat_forward_plain,
        pack_instances_flat,
    )
    from gsorb_slam_tpu_torch.raster.instances import (
        pack_raw_instances,
        rt_from_matrix,
        screen_rows,
    )
    from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
        preprocess_bwd,
        preprocess_bwd_plain,
        preprocess_fwd,
    )
    from gsorb_slam_tpu_torch.slam.tracking import (
        FeatureMatches,
        track_frame,
        tracking_raster_config,
    )
    from gsorb_slam_tpu_torch.profiling.common import (
        BLEND_APPLY_OPS_PER_PAIR,
        EVAL_OPS_PER_PAIR,
        PROJ_ADJ_OPS_PER_INSTANCE,
        PROJ_OPS_PER_INSTANCE,
        TRACK_BWD_APPLY_OPS_PER_PAIR,
        blend_ops,
        bound_ms,
    )
    from gsorb_slam_tpu_torch.splat.gaussians import add_points, empty_map

    dev = torch.device(DEVICE)
    checks = Checks()
    smi = nvidia_smi_line()
    print(f"# card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build (loading the library also turns TF32 off) ----
    t0 = time.perf_counter()
    _build.report_ptxas = True
    _build.library()
    print(f"# kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s)", flush=True)
    for line in _build.ptxas_report:  # per kernel: registers, spills, shared memory
        print(f"#   ptxas: {line}", flush=True)

    # ---- scene (bench.py:107-127) ----
    cam = Camera(**CAM_KW)
    rcfg = RasterConfig(
        tile=16, tile_capacity=2048, track_tile_capacity=512, max_dup=16, chunk=256,
        dilate_px=2.0, exact_stop=False,
    )
    rcfg_t = tracking_raster_config(rcfg)
    tcfg = TrackingConfig(num_iters=ITERS, early_stop_delta=0.0)
    rng = np.random.default_rng(0)
    means = np.stack(
        [rng.uniform(-2, 2, N_SPLATS), rng.uniform(-1.5, 1.5, N_SPLATS),
         rng.uniform(0.8, 4.0, N_SPLATS)], -1,
    ).astype(np.float32)
    rgb = rng.uniform(0, 1, (N_SPLATS, 3)).astype(np.float32)
    gm = add_points(
        empty_map(CAPACITY, device=dev), torch.as_tensor(means, device=dev),
        torch.as_tensor(rgb, device=dev), torch.as_tensor(means[:, 2], device=dev),
        torch.ones(N_SPLATS, dtype=torch.bool, device=dev), cam.fx, cam.fy,
    )
    params = (gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales, gm.active)
    T_id = torch.eye(4, device=dev)
    with torch.no_grad():
        prep = preprocess(*params, T_id, cam)
        bins_r = bin_gaussians(prep, cam, rcfg)
        packed_r = pack_instances(prep, bins_r)
    print(f"# scene: {int(gm.count)} splats, render bins: max count "
          f"{int(bins_r.counts.max())}, dropped {int(bins_r.n_dropped)}", flush=True)

    # ---- 2. K3 against its plain version ----
    ty_r, tx_r = tile_grid_shape(cam, rcfg)
    pu_r, pv_r = tile_pixels(torch.arange(ty_r * tx_r, device=dev), tx_r, rcfg.tile, rcfg.tile)
    with torch.no_grad():
        for exact in (False, True):
            cfg = dataclasses.replace(rcfg, exact_stop=exact)
            out_k, ct_k, last_k, visit_k = blend_forward(packed_r, bins_r.counts, cam, cfg)
            out_p, ct_p, last_p, visit_p = blend_forward_plain(packed_r, bins_r.counts, cam, cfg)
            torch.cuda.synchronize()
            worst = 0.0
            for name, rows, tol in (("color", slice(0, 3), 2e-3), ("depth", slice(3, 4), 5e-3),
                                    ("alpha", slice(4, 5), 2e-3), ("median", slice(5, 6), 5e-3),
                                    ("final_t", slice(6, 7), 2e-3)):
                err = float((out_k[:, rows] - out_p[:, rows]).abs().max())
                checks.record(f"K3 exact={int(exact)} {name} max-abs vs plain", err, tol)
                worst = max(worst, err)
            err = float((ct_k - ct_p).abs().max())
            checks.record(f"K3 exact={int(exact)} chunk_t max-abs vs plain", err, 2e-3)
            # The last applied slot moves only where a pixel's T sits at the
            # 1e-4 stop within rounding (as K4's, phase 7).
            checks.record(f"K3 exact={int(exact)} last-applied slots differing (share)",
                          int((last_k != last_p).sum()) / last_k.numel(), 1e-4)
            # K6's visit words, exactly the plain version's; K3's footprint
            # cull keeps every slot a warp applied.
            n_words = int((visit_k != visit_p).sum())
            print(f"# K3 exact={int(exact)} visit words: {n_words} of {visit_k.numel()} differ "
                  f"from the plain version's; {int(visit_k.ne(0).sum())} non-zero", flush=True)
            checks.record(f"K3 exact={int(exact)} visit words differing", n_words, 0)
            keep = footprint_keep(packed_r, pu_r, pv_r)  # [T, W, cap]
            applied = applied_slots(torch, visit_k, rcfg.chunk).transpose(1, 2)
            checks.record(f"K3 exact={int(exact)} applied slots the cull drops",
                          int((applied.reshape(keep.shape) & ~keep).sum()), 0)
            del keep, applied
            if not exact:
                k3_err = max(worst, err)

    # ---- tracking inputs: gt from K3 at identity, pack, pose 1 cm off ----
    with torch.no_grad():
        gt = render_binned(prep, bins_r, cam, rcfg)
        gt_color = gt.color
        gt_depth = torch.where(gt.alpha > 0.5, gt.median_depth, torch.zeros_like(gt.alpha))
        prep_t = preprocess(*params, T_id, cam)
        bins_t = bin_gaussians(prep_t, cam, rcfg_t)
        raw = pack_raw_instances(*params, bins_t)
        gt4 = tile_gt_images(gt_color, gt_depth, cam, rcfg_t)
    q1 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    t1 = torch.tensor([0.01, 0.0, 0.0], device=dev)
    rt1 = rt_from_matrix(pose_to_matrix(q1, t1)).contiguous()
    sm = 1.0

    # ---- 3a. K2f against its plain version ----
    with torch.no_grad():
        screen_k = preprocess_fwd(raw, rt1, cam, sm)
        screen_p = screen_rows(raw, rt1, cam, sm)
    k2f_err = float((screen_k - screen_p).abs().max())
    checks.record("K2f screen rows max |k-p|/(1e-4+1e-5|p|)",
                  close_err(screen_k, screen_p, 1e-4, 1e-5), 1.0)
    print(f"# K2f screen rows max-abs diff {k2f_err:.3e}", flush=True)

    # ---- 4. K1 against its plain version ----
    im_w, depth_w = tcfg.im_weight, tcfg.depth_weight
    counts_t = bins_t.counts
    with torch.no_grad():
        gt4_e, n_edge = gt_without_loss_edges(screen_k, counts_t, gt4, cam, rcfg_t)
    k1_err, d_screen, _ = check_tracking_kernel(
        torch, checks, "K1",
        lambda s_, g_, u: tracking_loss_grad(s_, counts_t, g_, cam, rcfg_t, im_w, depth_w, u),
        lambda s_, g_, u: tracking_loss_grad_plain(s_, counts_t, g_, cam, rcfg_t, im_w,
                                                   depth_w, u),
        raw, q1, t1, cam, gt4, gt4_e, n_edge)
    check_capacity_padding(
        torch, checks, "K1",
        lambda s_, g_, u: tracking_loss_grad(s_, counts_t, g_, cam, rcfg_t, im_w, depth_w, u),
        screen_k, gt4, 4 * raw.shape[2])
    # ---- 3b. K2b against its plain version (d_screen = K1's gradients) ----
    drt_k = preprocess_bwd(raw, rt1, d_screen, cam, sm)
    drt_p = preprocess_bwd_plain(raw, rt1, d_screen, cam, sm)
    k2b_err = float((drt_k - drt_p).abs().max())
    checks.record("K2b pose cotangent rel-err", rel_err(drt_k, drt_p), 1e-3)
    phase_k2b_edges(torch, checks, raw, rt1, d_screen, cam, sm)

    # ---- 5. the main path ----
    T_init = torch.eye(4, device=dev)
    T_init[:3, 3] = torch.tensor(T_INIT_TRANS, device=dev)
    matches = FeatureMatches.empty(device=dev)

    def run_frame():
        out = render_binned(prep, bins_r, cam, rcfg)
        gt_c = out.color
        gt_d = torch.where(out.alpha > 0.5, out.median_depth, torch.zeros_like(out.alpha))
        res = track_frame(gm, T_init, gt_c, gt_d, matches, cam, tcfg, rcfg_t,
                          rebin_iters=REBINS)
        view = render(*params, res.T_cw, cam, rcfg)  # the view at the tracked pose
        return out, res, view

    with torch.no_grad():
        psnr_init = psnr(render(*params, T_init, cam, rcfg).color, gt_color)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        out_main, res, view = run_frame()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    print(f"# main path launches: {json.dumps(launches)}", flush=True)
    for name in ("fused_track_fast", "preprocess_fwd", "preprocess_bwd"):
        checks.record(f"{name} launches == {ITERS}", launches[name], ITERS,
                      ok=launches[name] == ITERS)
    checks.record("blend_forward launches >= 1", launches["blend_forward"], 1,
                  ok=launches["blend_forward"] >= 1)
    T = res.T_cw
    images = (out_main.color, view.color, view.depth, view.alpha)
    finite = bool(torch.isfinite(T).all()) and all(bool(torch.isfinite(x).all()) for x in images)
    shapes = (tuple(T.shape) == (4, 4)
              and all(tuple(x.shape[:2]) == (cam.height, cam.width) for x in images))
    checks.record("outputs finite with expected shapes", 0.0, 0.0, ok=finite and shapes)
    # The view at the tracked pose must reproduce the gt far better than the
    # view at the initial pose: at least 6 dB (a 4x lower squared error).
    psnr_track = psnr(view.color, gt_color)
    print(f"# view PSNR against the gt: {psnr_track:.3f} dB at the tracked pose, "
          f"{psnr_init:.3f} dB at the initial pose", flush=True)
    checks.record("view PSNR gain, tracked over initial pose (dB, at least)",
                  psnr_track - psnr_init, 6.0, ok=psnr_track - psnr_init >= 6.0)
    err0 = math.sqrt(sum(v * v for v in T_INIT_TRANS))
    err_t = float(torch.linalg.norm(T[:3, 3]))
    q = rotmat_to_quat(T[:3, :3])
    err_r = float(2 * torch.atan2(torch.linalg.norm(q[1:]), q[0].abs()) * 180 / math.pi)
    print(f"# tracking: initial {err0 * 1e3:.2f} mm, final translation error "
          f"{err_t * 1e3:.4f} mm, rotation error {err_r:.5f} deg, loss {float(res.loss):.4f}, "
          f"{int(res.n_iters)} iterations, frame {main_s:.3f} s (first run)", flush=True)
    checks.record("final translation error / initial", err_t / err0, 0.1)

    # ---- 6. timings ----
    # FRAMES more frames from the same inputs: their spread within this
    # call, and (every kernel and reduction of the path being deterministic)
    # the same pose, bit for bit, as the main path's frame.
    frame_s = []
    same_pose = True
    for _ in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            r = track_frame(gm, T_init, gt_color, gt_depth, matches, cam, tcfg, rcfg_t,
                            rebin_iters=REBINS)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        same_pose &= bool(torch.equal(r.T_cw, T))
    checks.record(f"tracked pose bitwise equal in {FRAMES + 1} frames", 0.0, 0.0, ok=same_pose)
    q25, q50, q75 = (float(v) / ITERS * 1e3 for v in np.quantile(frame_s, (0.25, 0.5, 0.75)))
    ms_iter = min(frame_s) / ITERS * 1e3
    print(f"# track_frame ms/iteration over {FRAMES} frames of {ITERS} iterations incl. "
          f"rebins: best {ms_iter:.4f}, quartiles {q25:.4f} / {q50:.4f} / {q75:.4f}; frames "
          f"{', '.join(f'{s:.4f}' for s in frame_s)} s", flush=True)

    prof_t = profile_call(torch, lambda: track_frame(gm, T_init, gt_color, gt_depth, matches,
                                                     cam, tcfg, rcfg_t, rebin_iters=REBINS),
                          min(frame_s), "tracking frame")
    if prof_t is not None:
        print(f"# tracking frame: {prof_t['launches']} device launches (torch.profiler), "
              f"{prof_t['launches'] / ITERS:.2f} per iteration (the rebins' included)", flush=True)

    # ---- 7. K4 / K5 against their plain versions ----
    flat = phase_flat_kernels(torch, checks, gm, prep, bins_r, cam, rcfg)

    # ---- 8-9. the mapping step and its timings ----
    mp = phase_mapping(torch, checks, gm, cam, rcfg, dev)

    # ---- 10. K7 against its plain version on phase 4's pack ----
    rcfg_e = dataclasses.replace(rcfg_t, exact_stop=True)
    with torch.no_grad():
        gt4_e7, n_edge7 = gt_without_loss_edges(screen_k, counts_t, gt4, cam, rcfg_e)
    k7_err, _, _ = check_tracking_kernel(
        torch, checks, "K7",
        lambda s_, g_, u: tracking_loss_grad(s_, counts_t, g_, cam, rcfg_e, im_w, depth_w, u),
        lambda s_, g_, u: tracking_loss_grad_plain(s_, counts_t, g_, cam, rcfg_e, im_w,
                                                   depth_w, u),
        raw, q1, t1, cam, gt4, gt4_e7, n_edge7)

    # ---- 11. K8 against its plain version on the paired tracking view ----
    rcfg_p = tracking_raster_config(dataclasses.replace(rcfg, paired=True))
    with torch.no_grad():
        bins_p0 = bin_gaussians(prep_t, cam, rcfg_p)
        perm = tracking_pair_order(bins_p0, cam, rcfg_p)
        bins_p = pair_bins(bins_p0, perm)
        raw_p = pack_raw_instances(*params, bins_p)
        counts_p = bins_p.counts
        gt_pairs = pack_gt_pairs(gt_color, gt_depth, cam, rcfg_p, perm)
        screen_p0 = preprocess_fwd(raw_p, rt1, cam, sm)
        rows_e, n_edge8 = gt_without_loss_edges(screen_p0, counts_p, unpack_gt_pairs(gt_pairs),
                                                cam, rcfg_p, tile_ids=perm)
    print(f"# K8 view: {counts_p.numel()} rect tiles of 16x8 in {counts_p.numel() // 2} pairs, "
          f"capacity {raw_p.shape[2]}, max count {int(counts_p.max())}, chunks walked per pair "
          f"{int(((counts_p.reshape(-1, 2).amax(1) + rcfg_p.chunk - 1) // rcfg_p.chunk).sum())}"
          f" (rows unpaired: {int(((counts_p + rcfg_p.chunk - 1) // rcfg_p.chunk).sum())})",
          flush=True)
    k8_err, _, screen_pr = check_tracking_kernel(
        torch, checks, "K8",
        lambda s_, g_, u: tracking_loss_grad_paired(s_, counts_p, g_, cam, rcfg_p, im_w,
                                                    depth_w, u, tile_ids=perm),
        lambda s_, g_, u: tracking_loss_grad_paired_plain(s_, counts_p, g_, cam, rcfg_p, im_w,
                                                          depth_w, u, tile_ids=perm),
        raw_p, q1, t1, cam, gt_pairs, pair_gt_rows(rows_e), n_edge8)
    check_capacity_padding(
        torch, checks, "K8",
        lambda s_, g_, u: tracking_loss_grad_paired(s_, counts_p, g_, cam, rcfg_p, im_w,
                                                    depth_w, u, tile_ids=perm),
        screen_pr, gt_pairs, 4 * raw_p.shape[2])

    # ---- 12-13. the System and its two kernel configurations ----
    sysres = phase_system(torch, checks, dev)

    # ---- 14. K6 against its plain version ----
    k6 = phase_blend_backward(torch, checks, gm, packed_r, bins_r, cam, rcfg)

    # ---- 15-16. the multi-device path on a one-rank NCCL group ----
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh_res = phase_mesh(torch, checks, mp, cam, rcfg, dev)
            phase_mesh_tracking(torch, checks, mesh_res["mesh"], gm, T_init, gt_color, gt_depth,
                                res, screen_k, counts_t, gt4, cam, tcfg, rcfg_t)
        finally:
            dist.destroy_process_group()

    # ---- 17. K9 against its plain version, then its ablation table ----
    k9 = phase_ablation(torch, checks, screen_k, gt4, cam, rcfg_t, im_w, depth_w)

    # ---- 18. the profilers ----
    phase_profilers(torch, checks)

    # ---- 19-20. the disk path and the render path's leftovers ----
    with tempfile.TemporaryDirectory() as tmp:
        disk = phase_disk(torch, checks, dev, sysres["frames"], tmp)
        phase_scale_inits(torch, checks, dev, sysres["frames"], tmp)

        # ---- 21-23. the ORB frontend, the ORB System and loop closing ----
        fe_res = phase_frontend(torch, checks, dev)
        phase_orb_system(torch, checks, dev, fe_res["frames"])
        loop = phase_loop(torch, checks, dev)

        # ---- 24-27. the stereo and monocular entry points ----
        stereo = phase_stereo_system(torch, checks, dev)
        mono = phase_mono_system(torch, checks, dev)
        phase_sensor_modules(torch, checks, dev, stereo, mono)
        phase_sensor_apps(torch, checks, dev, stereo["frames"], os.path.join(tmp, "tum"), tmp)

        # ---- 28-35. the viewers, the graft entry points, LPIPS and the tools ----
        tools = [phase_viewer(torch, checks, dev, disk, tmp),
                 phase_web_viewer(torch, checks, dev, disk["system"]),
                 phase_entry(torch, checks, dev), phase_dryrun(torch, checks),
                 phase_lpips(torch, checks, dev, disk["system"], sysres["frames"][0], tmp),
                 phase_train_vocab(torch, checks, tmp),
                 phase_debug_loop(torch, checks, loop["events"]),
                 phase_disk_tools(torch, checks, tmp)]
        del disk["system"]
        tool_launches = {}
        for res in tools:
            for counts in res.get("launches", []):
                for k, v in counts.items():
                    tool_launches[k] = tool_launches.get(k, 0) + v
        print(f"# phases 28-35 launches: {json.dumps(tool_launches)}", flush=True)

    with torch.no_grad():
        k1_ms = time_ms(torch, lambda: tracking_loss_grad(
            screen_k, counts_t, gt4, cam, rcfg_t, im_w, depth_w, True), 20)
        k1_plain_ms = time_ms(torch, lambda: tracking_loss_grad_plain(
            screen_k, counts_t, gt4, cam, rcfg_t, im_w, depth_w, True), 2)
        k2f_ms = time_ms(torch, lambda: preprocess_fwd(raw, rt1, cam, sm), 50)
        k2f_plain_ms = time_ms(torch, lambda: screen_rows(raw, rt1, cam, sm), 5)
        k2b_ms = time_ms(torch, lambda: preprocess_bwd(raw, rt1, d_screen, cam, sm), 50)
        k2b_plain_ms = time_ms(torch, lambda: preprocess_bwd_plain(raw, rt1, d_screen, cam, sm), 5)
        k7_ms = time_ms(torch, lambda: tracking_loss_grad(
            screen_k, counts_t, gt4, cam, rcfg_e, im_w, depth_w, True), 20)
        k7_plain_ms = time_ms(torch, lambda: tracking_loss_grad_plain(
            screen_k, counts_t, gt4, cam, rcfg_e, im_w, depth_w, True), 2)
        k8_ms = time_ms(torch, lambda: tracking_loss_grad_paired(
            screen_pr, counts_p, gt_pairs, cam, rcfg_p, im_w, depth_w, True, tile_ids=perm), 20)
        k8_plain_ms = time_ms(torch, lambda: tracking_loss_grad_paired_plain(
            screen_pr, counts_p, gt_pairs, cam, rcfg_p, im_w, depth_w, True, tile_ids=perm), 2)
        k3_ms = time_ms(torch, lambda: blend_forward(packed_r, bins_r.counts, cam, rcfg), 20)
        k3_plain_ms = time_ms(torch, lambda: blend_forward_plain(
            packed_r, bins_r.counts, cam, rcfg), 2)
        k6_ms = time_ms(torch, lambda: blend_backward(packed_r, bins_r.counts, *k6["resid"],
                                                      k6["g"], cam, rcfg), 20)
        k6_plain_ms = time_ms(torch, lambda: blend_backward_plain(
            packed_r, bins_r.counts, k6["g"], cam, rcfg, tile_batch=150), 1)
        # K4 / K5 at the mapping step's shapes: the identity window frame's
        # layout and the map mapping starts from.
        cb_m = mp["layout"].cbins
        gm_m = mp["gm"]
        packed_m = pack_instances_flat(preprocess(
            gm_m.means, gm_m.rgb, gm_m.quats, gm_m.logit_opacities, gm_m.log_scales,
            gm_m.active, mp["pose"], cam), cb_m)
        fwd_m = blend_flat_forward(packed_m, cb_m, cam, rcfg)
        g_m = torch.randn(fwd_m[0].shape, generator=torch.Generator().manual_seed(3)).to(dev)
        k4_ms = time_ms(torch, lambda: blend_flat_forward(packed_m, cb_m, cam, rcfg), 20)
        k4_plain_ms = time_ms(torch, lambda: blend_flat_forward_plain(packed_m, cb_m, cam, rcfg), 1)
        k5_ms = time_ms(torch, lambda: blend_flat_backward(packed_m, cb_m, *fwd_m, g_m, cam, rcfg),
                        20)
        k5_plain_ms = time_ms(torch, lambda: blend_flat_backward_plain(
            packed_m, cb_m, g_m, cam, rcfg, tile_batch=300), 1)
        # The (pixel, instance) pairs this run's data needs, from the plain
        # blends (the same per-pixel loop as the kernels).
        pairs_k1, pairs_k3, pairs_k4, pairs_k7, pairs_k8 = {}, {}, {}, {}, {}
        tracking_blend(screen_k, counts_t, cam, rcfg_t, pairs=pairs_k1)
        tracking_blend(screen_k, counts_t, cam, rcfg_e, pairs=pairs_k7)
        tracking_blend(screen_pr, counts_p, cam, rcfg_p, tile_ids=perm, pairs=pairs_k8)
        blend_forward_plain(packed_r, bins_r.counts, cam, rcfg, pairs=pairs_k3)
        blend_flat_forward_plain(packed_m, cb_m, cam, rcfg, pairs=pairs_k4)
        live_m = float((cb_m.indices >= 0).sum())
        per_tile = torch.bincount((cb_m.tile_start[1:] - cb_m.tile_start[:-1]).long()).tolist()
        print(f"# K4 / K5 mapping layout: tiles by chunk count "
              f"{json.dumps(dict(enumerate(per_tile)))} (one block per tile)", flush=True)
        n_chunks_m = float(cb_m.n_chunks)
        nz_k2b = float((d_screen[:, list(POSE_SCREEN_ROWS)] != 0).any(1).sum())

    n_tiles, _, cap_t = raw.shape
    px = rcfg.tile * rcfg.tile
    live_t = float(counts_t.sum())
    live_r = float(bins_r.counts.sum())
    slots_t = n_tiles * cap_t
    n_chunks_r = rcfg.tile_capacity // rcfg.chunk
    # Bytes the function must move: K1 reads the 10 blend rows of its live
    # instances and the gt tiles, writes the whole gradient block; K2f maps
    # every slot (14 raw rows in, 16 screen rows out); K2b reads the 6 pose
    # cotangent rows of every slot and the 10 pose-relevant raw rows of the
    # slots whose cotangent is not zero. The blends' operations are those of
    # the slots their warps applied (blend_ops: warp_visits), walked once
    # forward and, for K1, K7 and K8, once more backward.
    track_apply = BLEND_APPLY_OPS_PER_PAIR + TRACK_BWD_APPLY_OPS_PER_PAIR
    b_k1, by_k1 = bound_ms(live_t * 10 * 4 + n_tiles * 4 * px * 4 + slots_t * 16 * 4,
                           blend_ops(pairs_k1, 2, track_apply))
    b_k7, by_k7 = bound_ms(live_t * 10 * 4 + n_tiles * 4 * px * 4 + slots_t * 16 * 4,
                           blend_ops(pairs_k7, 2, track_apply))
    live_p = float(counts_p.sum())
    slots_p = counts_p.numel() * raw_p.shape[2]
    b_k8, by_k8 = bound_ms(live_p * 10 * 4 + gt_pairs.numel() * 4 + slots_p * 16 * 4,
                           blend_ops(pairs_k8, 2, track_apply))
    b_k2f, by_k2f = bound_ms(slots_t * (14 + 16) * 4, slots_t * PROJ_OPS_PER_INSTANCE)
    b_k2b, by_k2b = bound_ms(
        slots_t * len(POSE_SCREEN_ROWS) * 4 + nz_k2b * POSE_RAW_ROWS * 4,
        nz_k2b * PROJ_ADJ_OPS_PER_INSTANCE)
    # K3 reads the live instances' 10 rows and writes out, chunk_t and K6's
    # residuals: the last applied slot per pixel and the visit words (one per
    # warp, chunk and 32 slots).
    words_r = n_tiles * n_chunks_r * (px // 32) * (rcfg.chunk // 32) * 4
    b_k3, by_k3 = bound_ms(
        live_r * 10 * 4 + n_tiles * (8 + n_chunks_r + 1 + 1) * px * 4 + words_r,
        blend_ops(pairs_k3, 1, BLEND_APPLY_OPS_PER_PAIR))
    # K4 reads the 10 blend rows of the live instances and writes the rows
    # out, the incoming T of every live chunk and the last applied slot per
    # pixel; K5 reads the same instances, those residuals, the final-T row
    # and six cotangent rows, and writes ten gradient rows per instance.
    resid_m = n_chunks_m * px * 4 + n_tiles * px * 4
    b_k4, by_k4 = bound_ms(live_m * 10 * 4 + n_tiles * 8 * px * 4 + resid_m,
                           blend_ops(pairs_k4, 1, BLEND_APPLY_OPS_PER_PAIR))
    b_k5, by_k5 = bound_ms(live_m * 10 * 4 + resid_m + n_tiles * 7 * px * 4 + live_m * 10 * 4,
                           blend_ops(pairs_k4, 1, TRACK_BWD_APPLY_OPS_PER_PAIR))
    # K6 reads the live instances' 10 blend rows, K3's residuals (chunk_t,
    # the last applied slot, the visit words) and six cotangent rows, and
    # writes the whole [T, 16, cap] gradient block (no wrapper fill: K6
    # writes every element, as K1 does its block). Its pairs are K3's.
    k6_read = live_r * 10 * 4 + n_tiles * (n_chunks_r + 1 + 1 + 6) * px * 4
    b_k6, by_k6 = bound_ms(k6_read + words_r + n_tiles * 16 * rcfg.tile_capacity * 4,
                           blend_ops(pairs_k3, 1, TRACK_BWD_APPLY_OPS_PER_PAIR))

    # The per-pixel formulas, for comparison: every pair each pixel walks on
    # its own (evaluated forward, to_last backward), no visit words written,
    # and K6 writing ten gradient rows per live instance after a wrapper fill.
    def per_pixel_ops(pr, fwd, bwd, apply_ops):
        return (fwd * pr["evaluated"] + bwd * pr["to_last"]) * EVAL_OPS_PER_PAIR + (
            pr["applied"] * apply_ops)

    per_pixel = {
        "K1": bound_ms(live_t * 10 * 4 + n_tiles * 4 * px * 4 + slots_t * 16 * 4,
                       per_pixel_ops(pairs_k1, 1, 1, track_apply)),
        "K3": bound_ms(live_r * 10 * 4 + n_tiles * (8 + n_chunks_r + 1) * px * 4,
                       per_pixel_ops(pairs_k3, 1, 0, BLEND_APPLY_OPS_PER_PAIR)),
        "K4": bound_ms(live_m * 10 * 4 + n_tiles * 8 * px * 4 + resid_m,
                       per_pixel_ops(pairs_k4, 1, 0, BLEND_APPLY_OPS_PER_PAIR)),
        "K5": bound_ms(live_m * 10 * 4 + resid_m + n_tiles * 7 * px * 4 + live_m * 10 * 4,
                       per_pixel_ops(pairs_k4, 0, 1, TRACK_BWD_APPLY_OPS_PER_PAIR)),
        "K6": bound_ms(k6_read + live_r * 10 * 4,
                       per_pixel_ops(pairs_k3, 0, 1, TRACK_BWD_APPLY_OPS_PER_PAIR)),
        "K7": bound_ms(live_t * 10 * 4 + n_tiles * 4 * px * 4 + slots_t * 16 * 4,
                       per_pixel_ops(pairs_k7, 1, 1, track_apply)),
        "K8": bound_ms(live_p * 10 * 4 + gt_pairs.numel() * 4 + slots_p * 16 * 4,
                       per_pixel_ops(pairs_k8, 1, 1, track_apply)),
    }
    floor = {"K1": (b_k1, by_k1), "K3": (b_k3, by_k3), "K4": (b_k4, by_k4), "K5": (b_k5, by_k5),
             "K6": (b_k6, by_k6), "K7": (b_k7, by_k7), "K8": (b_k8, by_k8)}
    print("# blend bounds, ms (the slots the warps applied; the per-pixel formula): "
          + ", ".join(f"{k} {floor[k][0]:.4f} by {floor[k][1]} ({per_pixel[k][0]:.4f} by "
                      f"{per_pixel[k][1]})" for k in floor), flush=True)
    for name, pr in (("K1", pairs_k1), ("K7", pairs_k7), ("K8", pairs_k8), ("K4 / K5", pairs_k4)):
        print(f"# {name} backward (lane, slot) pairs: {pr['warp_visits']} visited (the slots "
              f"each warp applied) against {pr['to_last']} to each pixel's last applied slot "
              f"({pr['warp_visits'] / max(pr['to_last'], 1):.4f})", flush=True)
    print(f"# K3 forward (lane, slot) pairs on the render bins: {pairs_k3['warp_kept']} kept "
          f"by the footprint cull against {pairs_k3['evaluated']} evaluated per pixel "
          f"({pairs_k3['warp_kept'] / max(pairs_k3['evaluated'], 1):.4f}); the visit words' "
          f"floor {pairs_k3['warp_visits']}", flush=True)
    print(f"# K6 backward (lane, slot) pairs on the render bins: {pairs_k3['warp_visits']} "
          f"visited against {pairs_k3['to_last']} to each pixel's last applied slot "
          f"({pairs_k3['warp_visits'] / max(pairs_k3['to_last'], 1):.4f})", flush=True)
    print(f"# K4 forward (lane, slot) pairs: {pairs_k4['warp_kept']} kept by the footprint "
          f"cull against {pairs_k4['evaluated']} evaluated per pixel "
          f"({pairs_k4['warp_kept'] / max(pairs_k4['evaluated'], 1):.4f}); the visit words' "
          f"floor {pairs_k4['warp_visits']}", flush=True)
    print(f"# (pixel, instance) pairs: K7 {json.dumps(pairs_k7)}, K8 {json.dumps(pairs_k8)} "
          f"over {live_p:.0f} live rect-tile instances", flush=True)
    print(f"# (pixel, instance) pairs: K1 {json.dumps(pairs_k1)}, K3 {json.dumps(pairs_k3)}, "
          f"K4 / K5 {json.dumps(pairs_k4)}; live instances: tracking {live_t:.0f}, render "
          f"{live_r:.0f}, mapping {live_m:.0f} in {n_chunks_m:.0f} chunks; K2b slots with a "
          f"pose cotangent: {nz_k2b:.0f} of {slots_t}", flush=True)

    def entry(name, source, replaces, launches_n, err, ms, plain_ms, b, by):
        # The count of the kernel's main path plus the stereo System's (phase
        # 24) and phases 28-35's (the viewers, the entry points, the tools).
        counter = {"K1": "fused_track_fast", "K2f": "preprocess_fwd", "K2b": "preprocess_bwd",
                   "K3": "blend_forward", "K4": "blend_flat_fwd", "K5": "blend_flat_bwd",
                   "K6": "blend_backward", "K7": "fused_track_exact", "K8": "paired_track",
                   "K9": "fused_track_ablate"}[name.split()[0]]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_n + stereo["launches"][counter]
                + tool_launches.get(counter, 0), "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": None}

    kernels = [
        entry("K1 fused_track_fast", "gsorb_slam_tpu_torch/csrc/fused_track.cu",
              "gsorb_slam_tpu/raster/pallas_raster.py:1492", launches["fused_track_fast"],
              k1_err, k1_ms, k1_plain_ms, b_k1, by_k1),
        entry("K2f preprocess_fwd", "gsorb_slam_tpu_torch/csrc/preprocess_instances.cu",
              "gsorb_slam_tpu/raster/preprocess_pallas.py:187", launches["preprocess_fwd"],
              k2f_err, k2f_ms, k2f_plain_ms, b_k2f, by_k2f),
        entry("K2b preprocess_bwd", "gsorb_slam_tpu_torch/csrc/preprocess_instances.cu",
              "gsorb_slam_tpu/raster/preprocess_pallas.py:214", launches["preprocess_bwd"],
              k2b_err, k2b_ms, k2b_plain_ms, b_k2b, by_k2b),
        entry("K3 blend_forward", "gsorb_slam_tpu_torch/csrc/blend_forward.cu",
              "gsorb_slam_tpu/raster/pallas_raster.py:615", launches["blend_forward"],
              k3_err, k3_ms, k3_plain_ms, b_k3, by_k3),
        entry("K4 blend_flat_fwd", "gsorb_slam_tpu_torch/csrc/blend_flat.cu",
              "gsorb_slam_tpu/raster/pallas_raster.py:1950", mp["launches"]["blend_flat_fwd"],
              flat["k4_err"], k4_ms, k4_plain_ms, b_k4, by_k4),
        entry("K5 blend_flat_bwd", "gsorb_slam_tpu_torch/csrc/blend_flat.cu",
              "gsorb_slam_tpu/raster/pallas_raster.py:2014", mp["launches"]["blend_flat_bwd"],
              flat["k5_err"], k5_ms, k5_plain_ms, b_k5, by_k5),
        entry("K6 blend_backward", "gsorb_slam_tpu_torch/csrc/blend_backward.cu",
              "gsorb_slam_tpu/raster/pallas_raster.py:659", mesh_res["launches"]["blend_backward"],
              k6["k6_err"], k6_ms, k6_plain_ms, b_k6, by_k6),
        entry("K7 fused_track_exact", "gsorb_slam_tpu_torch/csrc/fused_track.cu",
              "gsorb_slam_tpu/raster/pallas_raster.py:1435", sysres["fused_track_exact"],
              k7_err, k7_ms, k7_plain_ms, b_k7, by_k7),
        entry("K8 paired_track", "gsorb_slam_tpu_torch/csrc/fused_track.cu",
              "gsorb_slam_tpu/raster/paired.py:446", sysres["paired_track"],
              k8_err, k8_ms, k8_plain_ms, b_k8, by_k8),
        entry("K9 fused_track_ablate (full)", "gsorb_slam_tpu_torch/csrc/fused_track.cu",
              "scripts/profile_fused_ablate.py:255", k9["launches"], k9["err"],
              k9["table"]["variants"]["full"]["ms"], k9["plain_ms"],
              k9["table"]["bound_ms"]["full"]["ms"], k9["table"]["bound_ms"]["full"]["by"]),
    ]
    for k in kernels:
        print(f"# {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}), {k['launches']} launches on its "
              f"main path, the stereo System's and phases 28-35's", flush=True)
    print("# library_ms: null for every kernel: no single PyTorch call computes a "
          "depth-ordered alpha blend with its stop rules, its backward, or the EWA "
          "projection's pose adjoint", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if checks.failed:
        print(f"chip_smoke: FAILED checks: {checks.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
