"""Full-system benchmark on the TUM-like generated sequence (counterpart of
``gsorb_slam_tpu/apps/run_benchmark.py``).

The reference protocol's benchmark (``scripts/run_tum.sh``: per-run
``experiments/<name>/`` outputs with trajectory and ``result.txt``) pointed
at :class:`~gsorb_slam_tpu_torch.slam.dataset.TUMLikeDataset`, the stand-in
for TUM fr1 when no recording is at hand. Reports ATE RMSE, per-frame
timing and render quality (PSNR / SSIM / depth L1 over the estimated
trajectory and at the gauge-aligned ground truth), and the truncation's
blended-weight report at the last pose, writing the same artifacts as the
JAX package with ``"backend": "cuda"`` or ``"cpu"``.

Runs on the card; ``--cpu`` runs the kernels' plain versions on the CPU.
The defaults are the JAX package's: the ORB frontend (``--frontend orb``)
and TUM1's lens distortion warped into the images (``--no-distortion``
turns it off); ``--loop`` adds loop closing with the packaged vocabulary
(the sweep returns to its start, so a long run can close a loop). The JAX flags
that pick a TPU kernel layout (``--blend-bf16``, ``--elem-bf16``,
``--no-elem-bf16``, ``--no-preprocess-pallas``) raise: the port has no
such layout.

Usage:
    python -m gsorb_slam_tpu_torch.apps.run_benchmark --frames 100 \\
        --out experiments/tum_like [--frontend render] [--no-distortion] [--loop] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

# The JAX flags that choose a TPU kernel layout the port has no counterpart
# of: its kernels compute in float32 throughout and its preprocess is always
# the CUDA kernel. Each raises by name rather than run f32 under a bf16 label.
_TPU_ONLY_FLAGS = ("blend_bf16", "elem_bf16", "no_elem_bf16", "no_preprocess_pallas")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--track-iters", type=int, default=200)
    ap.add_argument("--map-iters", type=int, default=100)
    ap.add_argument("--no-distortion", action="store_true",
                    help="generate the sequence without TUM1's lens distortion")
    ap.add_argument("--no-noise", action="store_true")
    ap.add_argument("--frontend", default="orb", choices=["orb", "render"],
                    help="'orb' (the JAX default) raises until the ORB slice; pass 'render'")
    ap.add_argument("--max-gaussians", type=int, default=1 << 20)
    ap.add_argument("--out", default="experiments/tum_like")
    ap.add_argument("--eval-stride", type=int, default=1)
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "gsorb_bench_cache"))
    ap.add_argument("--dilate", type=float, default=None, help="override RasterConfig.dilate_px")
    ap.add_argument("--rebin-iters", type=int, nargs="*", default=None,
                    help="override in-loop tracking rebin iterations")
    ap.add_argument("--bucket-floor", type=int, default=0,
                    help="floor for the live-splat prefix bucket")
    for flag in _TPU_ONLY_FLAGS:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="a TPU kernel layout: raises (the port computes in float32 "
                             "and always preprocesses with its CUDA kernel)")
    ap.add_argument("--early-stop-delta", type=float, default=None,
                    help="override TrackingConfig.early_stop_delta "
                         "(0 = a fixed iteration count, no early stop)")
    ap.add_argument("--tile-capacity", type=int, default=None,
                    help="override RasterConfig.tile_capacity")
    ap.add_argument("--paired", action="store_true",
                    help="paired-rect tracking (16x8 rect tiles in pair-major order, K8)")
    ap.add_argument("--track-capacity", type=int, default=None,
                    help="override RasterConfig.track_tile_capacity")
    ap.add_argument("--track-chunk", type=int, default=None,
                    help="override the tracking view's chunk")
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closing (loads the packaged ORB vocabulary)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    return ap


def _raster_config(args, width: int):
    from gsorb_slam_tpu_torch.slam.system import System

    raster = System.default_raster_config(width)
    fields = {
        "dilate_px": args.dilate,
        "tile_capacity": args.tile_capacity,
        "paired": True if args.paired else None,
        "track_tile_capacity": args.track_capacity,
        "track_chunk": args.track_chunk,
    }
    changes = {k: v for k, v in fields.items() if v is not None}
    return dataclasses.replace(raster, **changes) if changes else None


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    for flag in _TPU_ONLY_FLAGS:
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} chooses a TPU kernel "
                                      "layout the port does not have")

    import torch

    from gsorb_slam_tpu_torch.core.config import (
        CameraConfig,
        DebugConfig,
        MappingConfig,
        ORBConfig,
        SystemConfig,
        TrackingConfig,
    )
    from gsorb_slam_tpu_torch.eval.ate import ate_rmse, gauge_align_gt_to_est
    from gsorb_slam_tpu_torch.eval.trajectory import save_tum
    from gsorb_slam_tpu_torch.ops.metrics import psnr, ssim, truncation_weight_report
    from gsorb_slam_tpu_torch.raster.preprocess import preprocess
    from gsorb_slam_tpu_torch.slam.dataset import TUMLikeDataset
    from gsorb_slam_tpu_torch.slam.system import System

    dev = torch.device("cpu" if args.cpu else "cuda")
    print(f"backend: {dev.type}", flush=True)
    t0 = time.time()
    ds = TUMLikeDataset(n_frames=args.frames, seed=args.seed, width=args.width,
                        height=args.height, apply_distortion=not args.no_distortion,
                        noise=not args.no_noise,
                        cache_dir=args.cache, device=dev)
    print(f"dataset built in {time.time() - t0:.1f}s "
          f"({len(ds)} frames {args.width}x{args.height})", flush=True)

    cam = ds.cam
    k1, k2, p1, p2, k3 = TUMLikeDataset.DIST if not args.no_distortion else (0, 0, 0, 0, 0)
    cfg = SystemConfig(
        camera=CameraConfig(width=args.width, height=args.height, fx=cam.fx, fy=cam.fy,
                            cx=cam.cx, cy=cam.cy, fps=30, k1=k1, k2=k2, p1=p1, p2=p2, k3=k3,
                            depth_map_factor=1.0),
        orb=ORBConfig(n_features=1000, n_levels=8),
        mapping=MappingConfig(num_iters=args.map_iters, init_iters=min(200, 4 * args.map_iters),
                              max_gaussians=args.max_gaussians, madien_mul=10.0),
        tracking=TrackingConfig(
            num_iters=args.track_iters,
            **({"rebin_iters": tuple(args.rebin_iters)} if args.rebin_iters is not None else {}),
            **({"early_stop_delta": args.early_stop_delta}
               if args.early_stop_delta is not None else {}),
        ),
        debug=DebugConfig(use_loop=args.loop),
    )
    sys_ = System(cfg, max_keyframes=128, frontend=args.frontend,
                  raster=_raster_config(args, args.width), device=dev)
    if args.bucket_floor:
        sys_.prefix_bucket_floor = args.bucket_floor

    # Per-frame progress persists as it happens: a run cut mid-sequence
    # still leaves its per-frame error and densify trace.
    os.makedirs(args.out, exist_ok=True)
    est, gt, lat = [], [], []
    with open(os.path.join(args.out, "frames.jsonl"), "a", buffering=1) as frames_log:
        for i, fr in enumerate(ds):
            tf = time.time()
            T = sys_.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
            lat.append(time.time() - tf)
            est.append(T)
            gt.append(fr.gt_T_cw)
            dR = T[:3, :3] @ fr.gt_T_cw[:3, :3].T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            # camera-centre error (what ATE measures)
            c_est = -T[:3, :3].T @ T[:3, 3]
            c_gt = -fr.gt_T_cw[:3, :3].T @ fr.gt_T_cw[:3, 3]
            terr = float(np.linalg.norm(c_est - c_gt))
            adds = sys_.densify_added[-1] if sys_.densify_added else 0
            n_act = int(sys_.gm.n_active())
            print(f"frame {i}/{len(ds)}  {lat[-1]:.2f}s splats={n_act} adds={adds} "
                  f"terr={terr * 100:.2f}cm rerr={ang:.3f}deg", flush=True)
            frames_log.write(json.dumps({
                "frame": i, "s": round(lat[-1], 3), "splats": n_act, "adds": int(adds),
                "terr_cm": round(terr * 100, 3), "rerr_deg": round(float(ang), 4),
            }) + "\n")

    rmse = float(ate_rmse(est, gt))
    summ = sys_.shutdown_summary()

    # Render quality over the estimated trajectory (the reference's
    # Evalution, src/Utils.cc:365-473), every eval-stride-th frame, and at
    # the ground-truth poses re-expressed in the map's gauge (Horn est ->
    # gt: the map is defined up to the rigid gauge its first keyframe
    # pins); the raw ground-truth poses' PSNR is kept beside it.
    gt_aligned = gauge_align_gt_to_est(est, gt)
    psnrs, ssims, dl1s, gt_psnrs, gt_dl1s, raw_gt_psnrs = [], [], [], [], [], []
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    for i in range(0, len(ds), args.eval_stride):
        fr = ds[i]
        rgb, depth = t(fr.rgb), t(fr.depth)
        mask = depth > 0
        with torch.no_grad():
            out = sys_.render_view(est[i])
            c = torch.clamp(out.color, 0.0, 1.0)
            psnrs.append(float(psnr(c, rgb, mask)))
            ssims.append(float(ssim(c, rgb)))
            md = out.median_depth
            valid = mask & (md > 0)
            if bool(valid.any()):
                dl1s.append(float((md - depth).abs()[valid].mean()))
            out_g = sys_.render_view(gt_aligned[i])
            gt_psnrs.append(float(psnr(torch.clamp(out_g.color, 0.0, 1.0), rgb, mask)))
            out_gr = sys_.render_view(fr.gt_T_cw)
            raw_gt_psnrs.append(float(psnr(torch.clamp(out_gr.color, 0.0, 1.0), rgb, mask)))
            mdg = out_g.median_depth
            vg = mask & (mdg > 0)
            if bool(vg.any()):
                gt_dl1s.append(float((mdg - depth).abs()[vg].mean()))

    save_tum(os.path.join(args.out, "CameraTrajectory.txt"),
             [(fr.timestamp, T) for fr, T in zip(ds, est)])
    result = {
        "sequence": f"tum_like_{args.frames}f_seed{args.seed}",
        "frames": len(ds),
        "ate_rmse_m": rmse,
        "psnr_db": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "depth_l1_m": float(np.mean(dl1s)) if dl1s else None,
        "psnr_db_gt_pose": float(np.mean(gt_psnrs)),
        "psnr_db_gt_pose_raw": float(np.mean(raw_gt_psnrs)),
        "depth_l1_m_gt_pose": float(np.mean(gt_dl1s)) if gt_dl1s else None,
        "mean_frame_s": float(np.mean(lat[1:])),
        "median_frame_s": float(np.median(lat[1:])),
        "avg_tracking_s": summ["avg_tracking_s"],
        "avg_mapping_s": summ["avg_mapping_s"],
        "total_frontend_s": summ["total_frontend_s"],
        "total_kf_chain_s": summ["total_kf_chain_s"],
        "avg_kf_chain_s": summ["avg_kf_chain_s"],
        "total_gaussians": summ["total_gaussians"],
        "n_keyframes": summ["n_keyframes"],
        "track_iters": args.track_iters,
        "map_iters": args.map_iters,
        "distortion": not args.no_distortion,
        "frontend": args.frontend,
        "backend": dev.type,
        "densify_added_mean": summ["densify_added_mean"],
        "densify_added_max": summ["densify_added_max"],
        "capacity_frac": summ["capacity_frac"],
        "loop_events": len(sys_.loop_events),
        # Kernel build seconds during the run (the port's only compile).
        "compile_s": summ.get("compile_s"),
        **{k: v for k, v in summ.items() if k.startswith(("phase_", "bin_"))},
    }
    # The blended-weight effect of the tile capacity's truncation on the map
    # at the last pose, against an oracle capacity that drops nothing: the
    # visible twin of bin_dropped_frac, which counts instances. It runs or
    # fails the run.
    gm = sys_.gm
    with torch.no_grad():
        prep = preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                          gm.active, t(est[-1]), sys_.cam)
    oc = sys_.rcfg.tile_capacity
    while oc < 1 << 15:
        oc *= 2
    rep = truncation_weight_report(prep, sys_.cam, sys_.rcfg, oracle_capacity=oc)
    result["trunc_weight_dropped_frac"] = round(rep["weight_dropped_frac"], 6)
    result["trunc_inst_dropped_frac"] = round(rep["inst_dropped_frac"], 6)
    result["trunc_oracle_dropped"] = rep["oracle_dropped"]
    with open(os.path.join(args.out, "result.txt"), "a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
