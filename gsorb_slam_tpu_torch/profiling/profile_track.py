"""Where a tracking iteration's time goes (counterpart of
``scripts/profile_track.py``).

``track_frame`` per iteration at the bench workload (the tracking view:
capacity 512, chunk 256; bench.py's initial offset) in the reference's two
variants, ``bench config`` (the budget's default rebins) and ``no rebin``,
each with the card's busy share and top kernels from ``torch.profiler``.
Beside them, on fixed bins at the initial pose:

- the bare kernel loop: K2f -> K1 -> K2b with no pose chain, no autograd,
  no Adam (the least an iteration could cost with these kernels);
- one iteration's value and pose gradient (the pose chain, K2f, K1 and
  autograd back through K2b), as ``track_frame`` computes it;
- one pose Adam step.

Their differences split an iteration's host time between the eager pose
chain with autograd, Adam, and the loop's own bookkeeping (best-pose keep,
rebins).

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_track [--iters 50]
[--cpu]``.
"""

from __future__ import annotations

import argparse

import torch

from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.core.transforms import matrix_to_pose
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import tile_gt_images, tracking_loss_grad
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix, screen_rows
from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
    preprocess_bwd,
    preprocess_bwd_plain,
    preprocess_fwd,
)
from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches, track_frame, tracking_raster_config
from gsorb_slam_tpu_torch.splat.gaussians import init_pose_state, pose_adam_step


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--iters", type=int, default=50, help="tracking iterations per frame")
    ap.add_argument("--runs", type=int, default=3, help="timed frames (best taken)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    rcfg = common.bench_raster_config()
    rcfg_t = tracking_raster_config(rcfg)
    gt_color, gt_depth = common.gt_images(gm, torch.eye(4, device=dev), cam, rcfg)
    T_init = common.initial_pose(dev)
    matches = FeatureMatches.empty(device=dev)
    res = {**common.device_info(dev), "iters": args.iters, "variants": {}}

    for name, rebins in (("bench config", None), ("no rebin", ())):
        tcfg = TrackingConfig(num_iters=args.iters, early_stop_delta=0.0)

        def frame(tcfg=tcfg, rebins=rebins):
            with torch.no_grad():
                return track_frame(gm, T_init, gt_color, gt_depth, matches, cam, tcfg, rcfg_t,
                                   rebin_iters=rebins)

        ms = common.wall_ms(frame, dev, runs=args.runs)
        prof = common.profile_call(frame, dev, best_ms=ms)
        res["variants"][name] = {"ms_per_iter": ms / args.iters, "frame_ms": ms,
                                 "profile": prof}
        common.report(f"track_frame, {name}", ms / args.iters, "per iteration")
        for line in common.profile_lines(prof, f"track_frame, {name}"):
            print(line, flush=True)

    # Fixed bins at the initial pose.
    tcfg = TrackingConfig(num_iters=args.iters, early_stop_delta=0.0)
    with torch.no_grad():
        bins = bin_gaussians(preprocess(*common.map_params(gm), T_init, cam), cam, rcfg_t)
        raw = pack_raw_instances(*common.map_params(gm), bins)
        gt4 = tile_gt_images(gt_color, gt_depth, cam, rcfg_t)
    rt = rt_from_matrix(T_init).contiguous()
    w = (tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth)
    k2f, k2b = (preprocess_fwd, preprocess_bwd) if dev.type == "cuda" else (
        screen_rows, preprocess_bwd_plain)

    def bare_loop():
        with torch.no_grad():
            for _ in range(args.iters):
                _, _, d = tracking_loss_grad(k2f(raw, rt, cam), bins.counts, gt4, cam, rcfg_t, *w)
                k2b(raw, rt, d, cam)

    quat, trans = matrix_to_pose(T_init)
    ps = init_pose_state(quat, trans)

    def value_and_grad():
        return common.pose_value_and_grad(raw, bins.counts, gt4, cam, rcfg_t, tcfg, quat, trans)

    _, gq, gt_ = value_and_grad()
    res["bare_loop_ms_per_iter"] = common.wall_ms(bare_loop, dev, runs=args.runs) / args.iters
    res["value_and_grad_ms"] = common.wall_ms(value_and_grad, dev, reps=args.iters, runs=args.runs)
    res["pose_adam_ms"] = common.wall_ms(lambda: pose_adam_step(ps, gq, gt_, tcfg), dev,
                                         reps=args.iters, runs=args.runs)
    common.report("bare loop K2f -> K1 -> K2b, fixed bins", res["bare_loop_ms_per_iter"],
                  "per iteration")
    common.report("value and pose gradient (pose chain + autograd)", res["value_and_grad_ms"])
    common.report("pose Adam step", res["pose_adam_ms"])
    it = res["variants"]["no rebin"]["ms_per_iter"]
    res["split_ms"] = {
        "kernels_and_launches": res["bare_loop_ms_per_iter"],
        "pose_chain_and_autograd": res["value_and_grad_ms"] - res["bare_loop_ms_per_iter"],
        "adam": res["pose_adam_ms"],
        "loop_rest": it - res["value_and_grad_ms"] - res["pose_adam_ms"],
    }
    print(f"# a no-rebin iteration, {it:.4f} ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res["split_ms"].items()) + " ms", flush=True)
    return res


if __name__ == "__main__":
    main()
