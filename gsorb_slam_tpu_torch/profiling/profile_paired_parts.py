"""The paired-rect tracking iteration (K8) against the square one (K1), part
by part (counterpart of ``scripts/profile_paired_parts.py``).

Both in the System's tracking view (capacity 512, chunk 256; paired: 16x8
rect tiles in count-sorted pairs) at the bench scene, identity pose:

    kernel alone                 K1 / K8 on their packs
    kernel, counts <= n K        the same launches with each tile's count
                                 clamped to 0, 1 and 2 chunks: the fixed
                                 per-tile cost and the cost per chunk walked
    preprocess VJP               K2f and K2b on each raw pack (autograd,
                                 d/dpose under a cotangent of ones)
    pack gather                  ``pack_raw_instances`` for each view
    rebin                        binning (paired: and the pair order)

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_paired_parts [--cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    pack_instances,
    tile_gt_images,
    tracking_loss_grad,
)
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
from gsorb_slam_tpu_torch.raster.paired import (
    pack_gt_pairs,
    pair_bins,
    tracking_loss_grad_paired,
    tracking_pair_order,
)
from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel
from gsorb_slam_tpu_torch.slam.tracking import tracking_raster_config


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--reps", type=int, default=10, help="calls per timed run")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    rcfg = common.bench_raster_config()
    sq = tracking_raster_config(rcfg)
    pr = tracking_raster_config(dataclasses.replace(rcfg, paired=True))
    tcfg = TrackingConfig()
    w = (tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth)
    T = torch.eye(4, device=dev)
    params = common.map_params(gm)
    gt_color, gt_depth = common.gt_images(gm, T, cam, rcfg)
    with torch.no_grad():
        prep = preprocess(*params, T, cam)
        bins_s = bin_gaussians(prep, cam, sq)
        packed_s = pack_instances(prep, bins_s)
        gt4_s = tile_gt_images(gt_color, gt_depth, cam, sq)
        bins_r = bin_gaussians(prep, cam, pr)
        perm = tracking_pair_order(bins_r, cam, pr)
        bins_p = pair_bins(bins_r, perm)
        packed_p = pack_instances(prep, bins_p)
        gt_p = pack_gt_pairs(gt_color, gt_depth, cam, pr, perm)
    K = sq.chunk
    print(f"# square instances {int(bins_s.counts.sum())} in {bins_s.counts.numel()} tiles; "
          f"paired {int(bins_p.counts.sum())} in {bins_p.counts.numel()} rect tiles; K {K}; "
          f"{common.device_info(dev)['name']}", flush=True)

    def square(counts):
        return lambda: tracking_loss_grad(packed_s, counts, gt4_s, cam, sq, *w)

    def paired(counts):
        return lambda: tracking_loss_grad_paired(packed_p, counts, gt_p, cam, pr, *w,
                                                 tile_ids=perm)

    def vjp(bins):
        raw = pack_raw_instances(*params, bins)
        rt = rt_from_matrix(T).contiguous()

        def run():
            r = rt.detach().requires_grad_(True)
            with torch.enable_grad():
                scr = preprocess_instances_kernel(raw, r, cam)
                return torch.autograd.grad(scr, r, torch.ones_like(scr))
        return run

    def rebin_paired():
        b = bin_gaussians(prep, cam, pr)
        return pair_bins(b, tracking_pair_order(b, cam, pr))

    pieces = {"square kernel alone (K1)": square(bins_s.counts),
              "paired kernel alone (K8)": paired(bins_p.counts)}
    for n in (0, 1, 2):
        pieces[f"square kernel, counts <= {n} K"] = square(torch.clamp(bins_s.counts, max=n * K))
        pieces[f"paired kernel, counts <= {n} K"] = paired(torch.clamp(bins_p.counts, max=n * K))
    pieces.update({
        "preprocess VJP, square pack": vjp(bins_s),
        "preprocess VJP, paired pack": vjp(bins_p),
        "pack gather, square": lambda: pack_raw_instances(*params, bins_s),
        "pack gather, paired": lambda: pack_raw_instances(*params, bins_p),
        "rebin, square": lambda: bin_gaussians(prep, cam, sq),
        "rebin, rect + pair order": rebin_paired,
    })
    res = {**common.device_info(dev), "ms": {}}
    with torch.no_grad():
        for name, fn in pieces.items():
            kernel = "kernel" in name
            ms = (common.time_ms(fn, dev, args.reps) if kernel
                  else common.wall_ms(fn, dev, reps=args.reps))
            res["ms"][name] = ms
            common.report(name, ms)
    return res


if __name__ == "__main__":
    main()
