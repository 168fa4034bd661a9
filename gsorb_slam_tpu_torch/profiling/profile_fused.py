"""Sweep K1's one knob, the chunk K, at the bench workload (counterpart of
``scripts/profile_fused.py``).

The TPU script swept its kernel's TPU knobs (tiles per grid step, chunk
unroll, the bf16 passes, the chunk). K1 has one: the chunk K, the instances
a block stages in shared memory at a time (and the granularity of its
chunk-level exit). At tracking capacity 512, for K = 64, 128, 256: K1 alone
on the pack at the identity pose, and a whole tracking iteration's pose
gradient (the pose chain, K2f, K1, autograd through K2b).

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_fused
[--chunks 64,128,256] [--cpu]``.
"""

from __future__ import annotations

import argparse

import torch

from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.core.transforms import matrix_to_pose
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    pack_instances,
    tile_gt_images,
    tracking_loss_grad,
)
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--capacity", type=int, default=512, help="tile capacity")
    ap.add_argument("--chunks", default="64,128,256", help="the chunks K to sweep")
    ap.add_argument("--reps", type=int, default=20, help="calls per timed run")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    tcfg = TrackingConfig()
    w = (tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth)
    T = torch.eye(4, device=dev)
    params = common.map_params(gm)
    quat, trans = matrix_to_pose(T)
    res = {**common.device_info(dev), "capacity": args.capacity, "chunks": {}}
    for K in (int(k) for k in args.chunks.split(",")):
        cfg = RasterConfig(tile=16, tile_capacity=args.capacity, max_dup=16, chunk=K,
                           dilate_px=2.0, exact_stop=False)
        with torch.no_grad():
            prep = preprocess(*params, T, cam)
            bins = bin_gaussians(prep, cam, cfg)
            packed = pack_instances(prep, bins)
            raw = pack_raw_instances(*params, bins)
            gt4 = tile_gt_images(*common.gt_images(gm, T, cam, cfg), cam, cfg)
            kernel = common.time_ms(
                lambda: tracking_loss_grad(packed, bins.counts, gt4, cam, cfg, *w), dev, args.reps)
            iteration = common.wall_ms(
                lambda: common.pose_value_and_grad(raw, bins.counts, gt4, cam, cfg, tcfg, quat,
                                                   trans), dev, reps=args.reps)
        res["chunks"][K] = {"kernel_ms": kernel, "iteration_ms": iteration}
        common.report(f"K1 alone, K = {K}", kernel)
        common.report(f"tracking iteration (pose gradient), K = {K}", iteration)
    res["best_chunk"] = min(res["chunks"], key=lambda k: res["chunks"][k]["kernel_ms"])
    print(f"# fastest K1: K = {res['best_chunk']}", flush=True)
    return res


if __name__ == "__main__":
    main()
