"""Two or more source trees of the port, measured in turns on one card.

Each ``--run LABEL=DIR`` starts a process that imports the port and
``chip_smoke.py`` from ``DIR`` (a checkout, or a commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists; a variant of a
lever is a copy of the tree with the lever edited), builds its kernels and
measures, at ``chip_smoke.py``'s main-path shapes (the bench scene of
``profiling/common.py``: TUM1's camera at 640x480, 250,000 random splats):

- each redesigned kernel's time by CUDA events (``profiling.common.time_ms``):
  K1 and K7 on the tracking pack 1 cm off, K2f on that pack and K2b on K1's
  gradients there, K8 on the paired view (K1 and K8 also at each other
  tracking capacity of ``--caps``), K4 and K5 under both stop rules on the
  render bins' flat layout (chip_smoke's phase 7) and, unless
  ``--kernels-only``, on the mapping step's layout
  (``chip_smoke.phase_mapping``), K3 and K6 under both stop rules on the
  render bins, K9's variants (``profile_fused_ablate``);
- a SHA-256 of each kernel's outputs (K4's visit words included; K3's words
  apart from its other outputs, which a tree without words also has), so
  two trees' results can be compared bit for bit across processes;
- K2b's device launches per call and, unless ``--kernels-only``, a
  tracking frame's, counted by ``torch.profiler``;
- unless ``--kernels-only``: tracking ms per iteration (``track_frame``, 200
  iterations with bench.py's rebins, the median of ``--frames`` frames),
  mapping ms per iteration (``map_window``, 100 iterations, the median of
  3 calls) and the System's frame time (``chip_smoke.phase_system``, its
  rerun and kernel-configuration runs cut to 2 frames).

The runs go one after another in the order given, so ``--run parent=P
--run change=. --run change=. --run parent=P`` alternates two trees.
Each measurement uses only entry points both trees share; it reads the
tree's own ``chip_smoke.py`` for the mapping step and the System.

Usage (on the card, from the repository's root): ``python compare_trees.py
--run parent=build/parent --run change=. --run change=. --run parent=build/parent
[--kernels-only] [--caps 512,1024,2048] [--out compare.json]``. It prints
one line per measurement and run, then a table of every run's values by
label.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

RESULT = "COMPARE_RESULT "


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_launches(torch, fn) -> int:
    """Device activities (kernels, copies, fills) of one call of ``fn``,
    counted by ``torch.profiler`` here: a parent tree's
    ``profiling.common.profile_call`` may not count them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def measure(kernels_only: bool, frames: int, caps: list[int]) -> dict:
    """One tree's measurements (run inside that tree, on the card)."""
    import dataclasses

    import numpy as np
    import torch

    # The tree's own port and chip_smoke, not those beside this script.
    sys.path[0] = os.getcwd()
    import chip_smoke as cs

    from gsorb_slam_tpu_torch import _build

    dev = torch.device(cs.DEVICE)
    if dev.type == "cuda":
        _build.library()

    from gsorb_slam_tpu_torch.core.config import MappingConfig, TrackingConfig
    from gsorb_slam_tpu_torch.profiling import profile_fused_ablate
    from gsorb_slam_tpu_torch.profiling.common import (
        bench_camera,
        bench_raster_config,
        bench_scene,
        device_info,
        initial_pose,
        map_params,
        sync,
        time_ms,
    )
    from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess, render_binned
    from gsorb_slam_tpu_torch.raster.binning import chunk_layout, tile_grid_shape
    from gsorb_slam_tpu_torch.raster.blend_kernels import (
        blend_backward,
        blend_forward,
        pack_instances,
        tile_gt_images,
        tracking_loss_grad,
    )
    from gsorb_slam_tpu_torch.raster.flat_kernels import (
        blend_flat_backward,
        blend_flat_forward,
        pack_instances_flat,
    )
    from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
    from gsorb_slam_tpu_torch.raster.paired import (
        pack_gt_pairs,
        pair_bins,
        tracking_loss_grad_paired,
        tracking_pair_order,
    )
    from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
        preprocess_bwd,
        preprocess_fwd,
        preprocess_instances_kernel,
    )
    from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
    from gsorb_slam_tpu_torch.slam.mapping import map_window, window_chunk_budget
    from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches, track_frame, tracking_raster_config
    from gsorb_slam_tpu_torch.splat.gaussians import prefix_view

    res: dict = {"device": device_info(dev)["name"], "ms": {}, "digest": {}, "count": {}}
    checks = cs.Checks()

    # The scene of chip_smoke.main (bench.py:107-127).
    cam = bench_camera()
    rcfg = bench_raster_config()
    rcfg_t = tracking_raster_config(rcfg)
    rcfg_e = dataclasses.replace(rcfg_t, exact_stop=True)
    tcfg = TrackingConfig(num_iters=cs.ITERS, early_stop_delta=0.0)
    w = (tcfg.im_weight, tcfg.depth_weight, True)
    gm = bench_scene(dev, cam)
    params = map_params(gm)
    T_id = torch.eye(4, device=dev)
    rt1 = rt_from_matrix(pose_to_matrix(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                                        torch.tensor([0.01, 0.0, 0.0], device=dev))).contiguous()

    def timed(name, fn, reps=20, digest=None):
        res["ms"][name] = time_ms(fn, dev, reps)
        if digest is not None:
            res["digest"][name] = _digest(*digest(fn()))
        print(f"# {name}: {res['ms'][name]:.4f} ms"
              + (f", digest {res['digest'][name]}" if name in res["digest"] else ""), flush=True)

    with torch.no_grad():
        prep = preprocess(*params, T_id, cam)
        bins_r = bin_gaussians(prep, cam, rcfg)
        packed_r = pack_instances(prep, bins_r)
        gt = render_binned(prep, bins_r, cam, rcfg)
        gt_color = gt.color
        gt_depth = torch.where(gt.alpha > 0.5, gt.median_depth, torch.zeros_like(gt.alpha))
        bins_t = bin_gaussians(prep, cam, rcfg_t)
        raw = pack_raw_instances(*params, bins_t)
        gt4 = tile_gt_images(gt_color, gt_depth, cam, rcfg_t)
        screen = preprocess_instances_kernel(raw, rt1, cam)
        counts = bins_t.counts
        timed("K1", lambda: tracking_loss_grad(screen, counts, gt4, cam, rcfg_t, *w),
              digest=lambda r: r)
        d_screen = tracking_loss_grad(screen, counts, gt4, cam, rcfg_t, *w)[2]
        timed("K2f", lambda: preprocess_fwd(raw, rt1, cam), 50, digest=lambda r: (r,))
        timed("K2b", lambda: preprocess_bwd(raw, rt1, d_screen, cam), 50, digest=lambda r: (r,))
        if dev.type == "cuda":
            res["count"]["K2b device launches per call"] = _device_launches(
                torch, lambda: preprocess_bwd(raw, rt1, d_screen, cam))
        timed("K7", lambda: tracking_loss_grad(screen, counts, gt4, cam, rcfg_e, *w),
              digest=lambda r: r)
        for cap in [rcfg.track_tile_capacity] + [c for c in caps
                                                 if c != rcfg.track_tile_capacity]:
            at = "" if cap == rcfg.track_tile_capacity else f" cap {cap}"
            if at:
                rc = tracking_raster_config(bench_raster_config(track_tile_capacity=cap))
                bins_c = bin_gaussians(prep, cam, rc)
                screen_c = preprocess_instances_kernel(pack_raw_instances(*params, bins_c), rt1,
                                                       cam)
                timed("K1" + at, lambda: tracking_loss_grad(screen_c, bins_c.counts, gt4, cam,
                                                            rc, *w), digest=lambda r: r)
            rcfg_p = tracking_raster_config(bench_raster_config(track_tile_capacity=cap,
                                                                paired=True))
            bins_p0 = bin_gaussians(prep, cam, rcfg_p)
            perm = tracking_pair_order(bins_p0, cam, rcfg_p)
            bins_p = pair_bins(bins_p0, perm)
            screen_p = preprocess_instances_kernel(pack_raw_instances(*params, bins_p), rt1, cam)
            gt_pairs = pack_gt_pairs(gt_color, gt_depth, cam, rcfg_p, perm)
            timed("K8" + at, lambda: tracking_loss_grad_paired(
                screen_p, bins_p.counts, gt_pairs, cam, rcfg_p, *w, tile_ids=perm),
                digest=lambda r: r)
        # K3 and K6 on the render bins under both stop rules. Only a tree
        # whose K3 records visit words returns them (and only its K6 takes
        # them): K3's digest is of its rows, chunk_t and last slots, its
        # words have a digest of their own, and K6 takes whatever residuals
        # its tree's K3 returned.
        for exact in (False, True):
            cfg = dataclasses.replace(rcfg, exact_stop=exact)
            at = " exact" if exact else ""
            fwd = blend_forward(packed_r, bins_r.counts, cam, cfg)
            timed("K3" + at, lambda: blend_forward(packed_r, bins_r.counts, cam, cfg),
                  digest=lambda r: r[:3])
            if len(fwd) > 3:
                res["digest"]["K3 words" + at] = _digest(fwd[3])
            g_r = torch.randn(fwd[0].shape, generator=torch.Generator().manual_seed(2)).to(dev)
            g_r[:, 5] = g_r[:, 7] = 0.0
            timed("K6" + at, lambda: blend_backward(packed_r, bins_r.counts, *fwd[1:], g_r, cam,
                                                     cfg), digest=lambda r: (r,))

    # K4 / K5 on the render bins' flat layout (chip_smoke's phase 7) under
    # both stop rules and, unless --kernels-only, at the mapping step's
    # shapes (its phases 8-9).
    with torch.no_grad():
        ty, tx = tile_grid_shape(cam, rcfg)
        cb_r = chunk_layout(bins_r, ty * tx, rcfg.chunk,
                            window_chunk_budget(bins_r.counts[None], rcfg.chunk))
        layouts = [("", cb_r, pack_instances_flat(prep, cb_r))]
        if not kernels_only:
            mp = cs.phase_mapping(torch, checks, gm, cam, rcfg, dev)
            gm_m = mp["gm"]
            cb_m = mp["layout"].cbins
            layouts.append((" mapping", cb_m, pack_instances_flat(preprocess(
                gm_m.means, gm_m.rgb, gm_m.quats, gm_m.logit_opacities, gm_m.log_scales,
                gm_m.active, mp["pose"], cam), cb_m)))
        for at, cb, packed_m in layouts:
            for exact in (False, True):
                cfg = dataclasses.replace(rcfg, exact_stop=exact)
                name = at + (" exact" if exact else "")
                fwd = blend_flat_forward(packed_m, cb, cam, cfg)
                g_m = torch.randn(fwd[0].shape,
                                  generator=torch.Generator().manual_seed(3)).to(dev)
                timed("K4" + name, lambda: blend_flat_forward(packed_m, cb, cam, cfg),
                      digest=lambda r: r)
                timed("K5" + name, lambda: blend_flat_backward(packed_m, cb, *fwd, g_m, cam, cfg),
                      digest=lambda r: (r,))
    abl = profile_fused_ablate.main(["--reps", "20"] if dev.type == "cuda" else
                                    ["--cpu", "--reps", "1", "--width", str(cam.width),
                                     "--height", str(cam.height), "--splats", str(cs.N_SPLATS),
                                     "--map-capacity", str(cs.CAPACITY)])
    for v, r in abl["variants"].items():
        res["ms"][f"K9 {v}"] = r["ms"]
    res["ms"]["K1 (K9's pack)"] = abl["k1_ms"]
    res["pairs"] = abl["pairs"]

    if not kernels_only:
        matches = FeatureMatches.empty(device=dev)
        T_init = initial_pose(dev)
        frame_s = []
        for _ in range(frames + 1):
            sync(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                r = track_frame(gm, T_init, gt_color, gt_depth, matches, cam, tcfg, rcfg_t,
                                rebin_iters=cs.REBINS)
            sync(dev)
            frame_s.append(time.perf_counter() - t0)
        res["digest"]["tracked pose"] = _digest(r.T_cw)
        res["ms"]["tracking ms / iteration"] = float(np.median(frame_s[1:])) / cs.ITERS * 1e3
        if dev.type == "cuda":
            with torch.no_grad():
                res["count"]["tracking frame device launches"] = _device_launches(
                    torch, lambda: track_frame(gm, T_init, gt_color, gt_depth, matches, cam, tcfg,
                                               rcfg_t, rebin_iters=cs.REBINS))
        mcfg = MappingConfig()
        n_iters = cs.MAP_ITERS or mcfg.num_iters
        frames_w = mp["frames"]
        budget = window_chunk_budget(frames_w.bins_counts, rcfg.chunk)
        prefix = 1 << 14
        while prefix < int(gm_m.count):
            prefix *= 2
        prefix = min(prefix, gm_m.capacity)
        draws = torch.randint(0, frames_w.n_frames, (n_iters,),
                              generator=torch.Generator().manual_seed(0)).tolist()
        call_s = []
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                m_v, _ = map_window(prefix_view(gm_m, prefix), frames_w, draws, cam, mcfg, rcfg,
                                    chunk_budget=budget)
            sync(dev)
            call_s.append(time.perf_counter() - t0)
        res["digest"]["mapped map"] = _digest(m_v.means, m_v.rgb, m_v.logit_opacities)
        res["ms"]["mapping ms / iteration"] = float(np.median(call_s)) / n_iters * 1e3
        cs.SYS_RERUN_FRAMES = 2
        cs.SYS_KERNEL_FRAMES = 2
        sysres = cs.phase_system(torch, checks, dev)
        e2e = sysres["e2e"]
        res["ms"]["System frame"] = e2e["frame_s_median"] * 1e3
        res["system"] = {k: e2e[k] for k in ("ate_rmse_m", "psnr_db", "depth_l1_m", "fps",
                                             "track_s_per_frame", "map_s_per_frame")}
    res["checks_failed"] = checks.failed
    return res


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "nvidia-smi failed"


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", default=[], metavar="LABEL=DIR",
                    help="a tree to measure, in order; repeat to alternate")
    ap.add_argument("--kernels-only", action="store_true",
                    help="kernel times and digests only (no tracking / mapping / System timing)")
    ap.add_argument("--frames", type=int, default=5, help="timed tracking frames per run")
    ap.add_argument("--caps", default="512",
                    help="tracking capacities at which K1 and K8 are timed (comma-separated)")
    ap.add_argument("--out", default=None, help="write every run's results here (JSON)")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        caps = [int(c) for c in args.caps.split(",")]
        print(RESULT + json.dumps(measure(args.kernels_only, args.frames, caps)), flush=True)
        return {}
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("compare_trees measures on the card: no CUDA device")
    smi = _smi()
    print(f"# card: {smi}", flush=True)
    runs = []
    for spec in args.run:
        label, _, tree = spec.partition("=")
        tree = str(Path(tree).resolve())
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure", "--frames",
               str(args.frames), "--caps", args.caps] + (["--kernels-only"] if args.kernels_only
                                                         else [])
        env = dict(os.environ, PYTHONPATH=tree)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        out = [json.loads(ln[len(RESULT):]) for ln in lines if ln.startswith(RESULT)]
        if proc.returncode != 0 or not out:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"run {label} ({tree}) failed with {proc.returncode}")
        r = dict(out[0], label=label, tree=tree, seconds=time.perf_counter() - t0)
        runs.append(r)
        for k, v in r["ms"].items():
            print(f"# {label}: {k} {v:.4f} ms" + (f" [{r['digest'][k]}]" if k in r["digest"]
                                                   else ""), flush=True)
        for k, v in r["count"].items():
            print(f"# {label}: {k} {v}", flush=True)
        if r.get("system"):
            print(f"# {label}: System {json.dumps(r['system'])}", flush=True)
        print(f"# {label}: {r['seconds']:.1f} s, checks failed: {r['checks_failed']}", flush=True)
    labels = list(dict.fromkeys(r["label"] for r in runs))
    names = list(dict.fromkeys(k for r in runs for k in r["ms"]))
    print("| measurement | " + " | ".join(labels) + " |")
    print("|---|" + "---|" * len(labels))
    for name in names:
        cells = []
        for lb in labels:
            vals = [r["ms"][name] for r in runs if r["label"] == lb and name in r["ms"]]
            cells.append(" / ".join(f"{v:.4f}" for v in vals) if vals else "—")
        print(f"| {name} | " + " | ".join(cells) + " |")
    for name in dict.fromkeys(k for r in runs for k in r["digest"]):
        ds = {lb: sorted({r["digest"][name] for r in runs if r["label"] == lb
                          and name in r["digest"]}) for lb in labels}
        print(f"# digest {name}: {json.dumps(ds)}")
    summary = {"card": smi, "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
