#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``gsorb_slam_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
The first run builds the CUDA kernels into ``build/kernels/``.

Workload: ``bench.py``'s tracking workload — TUM1's camera at 640x480, a
2^18-slot map holding 250,000 random splats made from
``np.random.default_rng(0)``, the production tracking raster view (tile 16,
tracking capacity 512, render capacity 2048, chunk 256, max_dup 16,
dilate 2 px, fast stop) and ``TrackingConfig(num_iters=200,
early_stop_delta=0)`` with rebins at (8, 40, 120).

Phases (any failed check makes the exit code non-zero):
1. the card's name and power limit; the kernel build;
2. K3 (forward blend) against its plain version at render capacity 2048;
3. K2f / K2b (instance projection and its pose adjoint) against their plain
   versions on the tracking pack at a pose 1 cm off;
4. K1 (fused tracking iteration) against its plain version: loss,
   per-instance gradients, and the pose gradient through K2b;
5. the main path: render the gt with ``render_binned`` (K3) at the identity
   pose, ``track_frame`` from bench.py's initial pose, then ``render`` the
   view at the tracked pose (K3); the final pose error must fall below 10%
   of the initial one, the tracked view must beat the initial pose's view
   by 6 dB PSNR against the gt, and every kernel of the path must have
   launched (K1 = K2f = K2b = 200, K3 >= 1);
6. timings: ms per tracking iteration over 10 more frames (best and
   quartiles; each frame must reproduce the main path's pose bit for bit),
   a profiled frame, and each kernel's time by CUDA events beside its plain
   version's and its bound (the work this run's data needs).
It prints a ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and f32 (non-tensor) FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations (an FMA counts 2) per (pixel, instance) pair, counted from
# the kernels' arithmetic. Every evaluated pair: falloff 11, power test 1,
# exp 1, opacity scale 1, clamp 1, alpha gate 1 -> 16. Every applied pair,
# forward: weight 1, transmittance 2, five accumulations 9, median test 2,
# stop test 1 -> 15. Every applied pair, tracking backward: T rebuild 2,
# weight 1, phi 7, d_alpha 3, suffix 3, d_power 2, ten gradient terms 25,
# their pixel sums 10 -> 53; the backward also evaluates the falloff again
# (16) for every pair up to the pixel's last applied instance. Per instance
# of the projection: ~160 (K2f) and, for a reverse-mode adjoint, ~3x that
# (K2b, only for instances whose cotangent is not zero).
EVAL_OPS_PER_PAIR = 16
BLEND_APPLY_OPS_PER_PAIR = 15
TRACK_BWD_APPLY_OPS_PER_PAIR = 53
PROJ_OPS_PER_INSTANCE = 160
PROJ_ADJ_OPS_PER_INSTANCE = 480
# Raw rows the pose adjoint reads (mean 3, world covariance 6, live 1) and
# the screen rows whose cotangent moves the pose (u, v, conic 3, depth).
POSE_RAW_ROWS = 10
POSE_SCREEN_ROWS = (0, 1, 2, 3, 4, 9)
FRAMES = 10

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
    """Device time per call of ``fn`` by CUDA events. A sleep kernel ahead
    of the timed run lets the host queue every launch first, so host-side
    wrapper overhead does not open gaps between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def close_err(a, b, atol: float, rtol: float) -> float:
    """max(|a - b| / (atol + rtol |b|)): <= 1 means every element is within tolerance."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


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
    from gsorb_slam_tpu_torch.raster.blend_kernels import (
        blend_forward,
        blend_forward_plain,
        gt_without_loss_edges,
        pack_instances,
        tile_gt_images,
        tracking_loss_grad,
        tracking_loss_grad_plain,
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
    from gsorb_slam_tpu_torch.splat.gaussians import add_points, empty_map

    dev = torch.device(DEVICE)
    checks = Checks()
    smi = nvidia_smi_line()
    print(f"# card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build (loading the library also turns TF32 off) ----
    t0 = time.perf_counter()
    _build.library()
    print(f"# kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s)", flush=True)

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
    with torch.no_grad():
        for exact in (False, True):
            cfg = dataclasses.replace(rcfg, exact_stop=exact)
            out_k, ct_k = blend_forward(packed_r, bins_r.counts, cam, cfg)
            out_p, ct_p = blend_forward_plain(packed_r, bins_r.counts, cam, cfg)
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
        for use_sur in (True, False):
            img_k, dep_k, g_k = tracking_loss_grad(screen_k, counts_t, gt4, cam, rcfg_t,
                                                   im_w, depth_w, use_sur)
            img_p, dep_p, g_p = tracking_loss_grad_plain(screen_k, counts_t, gt4, cam, rcfg_t,
                                                         im_w, depth_w, use_sur)
            torch.cuda.synchronize()
            lk, lp = float(img_k + dep_k), float(img_p + dep_p)
            checks.record(f"K1 use_sur={int(use_sur)} loss rel-err", abs(lk - lp) / abs(lp), 1e-3)
        # Per-instance gradients, leaving out the pixels where the loss is
        # discontinuous within rounding (see gt_without_loss_edges).
        gt4_e, n_edge = gt_without_loss_edges(screen_k, counts_t, gt4, cam, rcfg_t)
        print(f"# K1 gradient check: {n_edge} of {gt4.shape[0] * gt4.shape[2]} pixels left "
              f"out (loss discontinuous within rounding)", flush=True)
        for use_sur in (True, False):
            _, _, g_k = tracking_loss_grad(screen_k, counts_t, gt4_e, cam, rcfg_t,
                                           im_w, depth_w, use_sur)
            _, _, g_p = tracking_loss_grad_plain(screen_k, counts_t, gt4_e, cam, rcfg_t,
                                                 im_w, depth_w, use_sur)
            ratio = (g_k - g_p).abs() / (8e-4 + 2e-3 * g_p.abs())
            err = float(ratio.max())
            if not checks.record(f"K1 use_sur={int(use_sur)} grads max |k-p|/(8e-4+2e-3|p|)",
                                 err, 1.0):
                t_i, r_i, k_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
                print(f"#   worst: tile {t_i} row {r_i} slot {k_i} kernel "
                      f"{float(g_k[t_i, r_i, k_i]):.6e} plain {float(g_p[t_i, r_i, k_i]):.6e}; "
                      f"{int((ratio > 1).sum())} elements out of tolerance, rows "
                      f"{sorted(set((ratio > 1).nonzero()[:, 1].tolist()))}", flush=True)
            if use_sur:
                k1_err = float((g_k - g_p).abs().max())
                d_screen = g_k
    # ---- 3b. K2b against its plain version (d_screen = K1's gradients) ----
    drt_k = preprocess_bwd(raw, rt1, d_screen, cam, sm)
    drt_p = preprocess_bwd_plain(raw, rt1, d_screen, cam, sm)
    k2b_err = float((drt_k - drt_p).abs().max())
    checks.record("K2b pose cotangent rel-err", rel_err(drt_k, drt_p), 1e-3)

    # ---- 4b. pose gradient: K2f -> K1 -> K2b against plain + autograd ----
    def pose_grad(use_kernels: bool):
        q = q1.clone().requires_grad_(True)
        t = t1.clone().requires_grad_(True)
        with torch.enable_grad():
            rt = rt_from_matrix(pose_to_matrix(q, t))
            if use_kernels:
                from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
                    preprocess_instances_kernel,
                )
                screen = preprocess_instances_kernel(raw, rt, cam, sm)
                _, _, d = tracking_loss_grad(screen.detach(), counts_t, gt4, cam, rcfg_t,
                                             im_w, depth_w, True)
            else:
                screen = screen_rows(raw, rt, cam, sm)
                _, _, d = tracking_loss_grad_plain(screen.detach(), counts_t, gt4, cam, rcfg_t,
                                                   im_w, depth_w, True)
            torch.autograd.backward(screen, d)
        return q.grad, t.grad

    gq_k, gt_k = pose_grad(True)
    gq_p, gt_p = pose_grad(False)
    checks.record("pose grad (quat) rel-err, kernels vs plain", rel_err(gq_k, gq_p), 2e-2)
    checks.record("pose grad (trans) rel-err, kernels vs plain", rel_err(gt_k, gt_p), 2e-2)

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

    def psnr(img) -> float:
        mse = float(((img - gt_color) ** 2).mean())
        return 10.0 * math.log10(1.0 / max(mse, 1e-20))

    with torch.no_grad():
        psnr_init = psnr(render(*params, T_init, cam, rcfg).color)
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
    psnr_track = psnr(view.color)
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

    # One more frame under torch.profiler: the kernels' device time per
    # frame, its share of the profiled frame's wall time and of the best
    # unprofiled frame's (the profiler slows the host, not the kernels),
    # and the kernels that take the most device time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            track_frame(gm, T_init, gt_color, gt_depth, matches, cam, tcfg, rcfg_t,
                        rebin_iters=REBINS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    if busy_ms > 0:
        print(f"# profiled frame: {wall_ms:.3f} ms wall, {busy_ms:.3f} ms of kernels; "
              f"device busy {busy_ms / wall_ms:.4f} of the profiled frame, "
              f"{busy_ms / (min(frame_s) * 1e3):.4f} of the best unprofiled frame", flush=True)
        for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"#   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
                  f"{e.key[:90]}", flush=True)
    else:
        print("# profiled frame: the profiler recorded no device time (not measured)",
              flush=True)

    with torch.no_grad():
        k1_ms = time_ms(torch, lambda: tracking_loss_grad(
            screen_k, counts_t, gt4, cam, rcfg_t, im_w, depth_w, True), 20)
        k1_plain_ms = time_ms(torch, lambda: tracking_loss_grad_plain(
            screen_k, counts_t, gt4, cam, rcfg_t, im_w, depth_w, True), 2)
        k2f_ms = time_ms(torch, lambda: preprocess_fwd(raw, rt1, cam, sm), 50)
        k2f_plain_ms = time_ms(torch, lambda: screen_rows(raw, rt1, cam, sm), 5)
        k2b_ms = time_ms(torch, lambda: preprocess_bwd(raw, rt1, d_screen, cam, sm), 50)
        k2b_plain_ms = time_ms(torch, lambda: preprocess_bwd_plain(raw, rt1, d_screen, cam, sm), 5)
        k3_ms = time_ms(torch, lambda: blend_forward(packed_r, bins_r.counts, cam, rcfg), 20)
        k3_plain_ms = time_ms(torch, lambda: blend_forward_plain(
            packed_r, bins_r.counts, cam, rcfg), 2)
        # The (pixel, instance) pairs this run's data needs, from the plain
        # blends (the same per-pixel loop as the kernels).
        pairs_k1, pairs_k3 = {}, {}
        blend_forward_plain(screen_k, counts_t, cam, rcfg_t, pairs=pairs_k1)
        blend_forward_plain(packed_r, bins_r.counts, cam, rcfg, pairs=pairs_k3)
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
    # slots whose cotangent is not zero; K3 reads the live instances' 10
    # rows, writes out + chunk_t.
    b_k1, by_k1 = bound_ms(
        live_t * 10 * 4 + n_tiles * 4 * px * 4 + slots_t * 16 * 4,
        (pairs_k1["evaluated"] + pairs_k1["to_last"]) * EVAL_OPS_PER_PAIR
        + pairs_k1["applied"] * (BLEND_APPLY_OPS_PER_PAIR + TRACK_BWD_APPLY_OPS_PER_PAIR))
    b_k2f, by_k2f = bound_ms(slots_t * (14 + 16) * 4, slots_t * PROJ_OPS_PER_INSTANCE)
    b_k2b, by_k2b = bound_ms(
        slots_t * len(POSE_SCREEN_ROWS) * 4 + nz_k2b * POSE_RAW_ROWS * 4,
        nz_k2b * PROJ_ADJ_OPS_PER_INSTANCE)
    b_k3, by_k3 = bound_ms(
        live_r * 10 * 4 + n_tiles * (8 + n_chunks_r + 1) * px * 4,
        pairs_k3["evaluated"] * EVAL_OPS_PER_PAIR + pairs_k3["applied"] * BLEND_APPLY_OPS_PER_PAIR)
    print(f"# (pixel, instance) pairs: K1 {json.dumps(pairs_k1)}, K3 {json.dumps(pairs_k3)}; "
          f"live instances: tracking {live_t:.0f}, render {live_r:.0f}; K2b slots with a "
          f"pose cotangent: {nz_k2b:.0f} of {slots_t}", flush=True)

    def entry(name, source, replaces, launches_n, err, ms, plain_ms, b, by):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": None}

    kernels = [
        entry("K1 fused_track_fast", "gsorb_slam_tpu_torch/csrc/fused_track_fast.cu",
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
    ]
    for k in kernels:
        print(f"# {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}), {k['launches']} launches on the "
              f"main path", flush=True)
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
