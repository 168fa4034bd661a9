"""Mapping quality apart from tracking (counterpart of
``scripts/profile_mapping_quality.py``).

Drives the RGB-D ``System`` over a generated ``TUMLikeDataset`` with the
ground-truth poses injected (``track_rgbd(gt_pose=...)``: the pose
optimization is skipped; keyframing, densify and mapping run at the true
pose) with the reference script's budgets (QVGA, 100 mapping iterations,
window 8, covisible 4, 2^19 splats, capacity 2048, chunk 128, dilate 4 px),
then renders every frame at its true pose and reports PSNR over valid-depth
pixels, the depth L1 of the median depth and the splat count, per ablation:

    base        production settings
    freshbins   no keyframe-bin cache: every window keyframe rebinned every frame
    lr2         twice the mean, scale and rotation learning rates
    lrhalf      half of them

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_mapping_quality
[--frames 15] [--wh 320 240] [--ablate base,freshbins,lr2,lrhalf] [--cpu]``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.config import (
    CameraConfig,
    MappingConfig,
    SystemConfig,
    TrackingConfig,
)
from gsorb_slam_tpu_torch.ops.metrics import psnr
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.slam.dataset import TUMLikeDataset
from gsorb_slam_tpu_torch.slam.system import System

ABLATIONS = ("base", "freshbins", "lr2", "lrhalf")


def run_ablation(name: str, ds: TUMLikeDataset, args: argparse.Namespace,
                 dev: torch.device) -> dict:
    """One System over the sequence at the true poses, then its renders."""
    mkw = dict(num_iters=args.map_iters, max_gaussians=args.max_gaussians, window_size=8,
               covis_window=4)
    if name == "lr2":
        mkw.update(lr_mean3d=2e-4, lr_log_scales=2e-3, lr_unnorm_rotation=2e-3)
    elif name == "lrhalf":
        mkw.update(lr_mean3d=5e-5, lr_log_scales=5e-4, lr_unnorm_rotation=5e-4)
    elif name not in ("base", "freshbins"):
        raise ValueError(f"unknown ablation {name!r}; one of {ABLATIONS}")
    if args.init_iters is not None:
        mkw.update(init_iters=args.init_iters)
    cam = ds.cam
    cfg = SystemConfig(
        camera=CameraConfig(width=cam.width, height=cam.height, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                            cy=cam.cy, fps=30),
        mapping=MappingConfig(**mkw),
        tracking=TrackingConfig(num_iters=1),
    )
    rcfg = RasterConfig(tile=16, tile_capacity=2048, max_dup=16, chunk=128, dilate_px=4.0)
    system = System(cfg, max_keyframes=32, raster=rcfg, device=dev)
    if name == "freshbins":
        system.bins_ttl = 0
        system.bins_refresh_per_frame = 10**6
    t_all = time.perf_counter()
    frame_s = []
    for i in range(len(ds)):
        fr = ds[i]
        common.sync(dev)
        t0 = time.perf_counter()
        system.track_rgbd(fr.rgb, fr.depth, fr.timestamp, gt_pose=fr.gt_T_cw)
        common.sync(dev)
        frame_s.append(time.perf_counter() - t0)
        print(f"# {name} frame {i}: {frame_s[-1]:.3f} s, splats {int(system.gm.count)}, added "
              f"{system.densify_added[-1] if system.densify_added else 0}", flush=True)
    wall = time.perf_counter() - t_all
    ps, dl1 = [], []
    with torch.no_grad():
        for i in range(len(ds)):
            fr = ds[i]
            out = system.render_view(fr.gt_T_cw)
            depth = torch.as_tensor(fr.depth, device=dev)
            mask = depth > 0
            ps.append(float(psnr(out.color, torch.as_tensor(fr.rgb, device=dev), mask)))
            d = out.median_depth
            m = mask & (d > 0)
            dl1.append(float((d - depth).abs()[m].mean()) if bool(m.any()) else float("nan"))
    res = {"psnr": float(np.mean(ps)), "depth_l1": float(np.nanmean(dl1)),
           "splats": int(system.gm.count), "wall_s": wall, "frame_s": frame_s}
    print(f"ABLATE={name} frames={len(ds)} psnr={res['psnr']:.3f} depth_l1="
          f"{res['depth_l1']:.5f} splats={res['splats']} wall={wall:.2f}s", flush=True)
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (times are the CPU's, not the card's)")
    ap.add_argument("--frames", type=int, default=15)
    ap.add_argument("--wh", type=int, nargs=2, default=(320, 240))
    ap.add_argument("--map-iters", type=int, default=100)
    ap.add_argument("--init-iters", type=int, default=None,
                    help="frame 0's warm-up iterations (default: MappingConfig's)")
    ap.add_argument("--max-gaussians", type=int, default=1 << 19)
    ap.add_argument("--splat-spacing", type=float, default=0.02,
                    help="the generated room's splat spacing (m)")
    ap.add_argument("--ablate", default="base", help=f"comma-separated, of {','.join(ABLATIONS)}")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    W, H = args.wh
    t0 = time.perf_counter()
    ds = TUMLikeDataset(n_frames=args.frames, seed=0, width=W, height=H, apply_distortion=False,
                        noise=True, splat_spacing=args.splat_spacing, device=dev)
    print(f"# TUM-like sequence of {args.frames} frames of {W}x{H} generated in "
          f"{time.perf_counter() - t0:.2f} s; {common.device_info(dev)['name']}", flush=True)
    return {**common.device_info(dev), "frames": args.frames, "wh": [W, H],
            "ablations": {a: run_ablation(a, ds, args, dev) for a in args.ablate.split(",")}}


if __name__ == "__main__":
    main()
