"""The mapping raster iteration piece by piece: preprocess / pack / blend /
scatter (counterpart of ``scripts/profile_map_iter.py``).

At the bench scene with the reference's view of this script (tile 16,
capacity 1024, chunk 256, dilate 4 px), at the identity pose:

    preprocess fwd           the per-Gaussian projection
    preprocess fwd+bwd       and its autograd backward (d/dmeans)
    pack                     the per-tile pack gather from a fixed projection
    pack fwd+bwd             the gather and its fixed-order sorted backward
    blend fwd                K3
    full raster iteration    preprocess -> pack -> K3 -> loss -> K6 -> the
                             pack's backward -> preprocess's backward (d/dmeans)

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_map_iter [--cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_and_untile,
    blend_forward,
    pack_instances,
    tile_pack_grad_aux,
)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--capacity", type=int, default=1024, help="tile capacity")
    ap.add_argument("--reps", type=int, default=10, help="calls per timed run")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    cfg = RasterConfig(tile=16, tile_capacity=args.capacity, max_dup=16, chunk=256,
                       dilate_px=4.0, exact_stop=False)
    T = torch.eye(4, device=dev)
    rest = (gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales, gm.active, T, cam)
    with torch.no_grad():
        prep = preprocess(gm.means, *rest)
        bins = bin_gaussians(prep, cam, cfg)
        packed = pack_instances(prep, bins)
    aux = tile_pack_grad_aux(bins, gm.capacity)
    print(f"# instances {int(bins.counts.sum())}, tiles {bins.indices.shape[0]}, capacity "
          f"{args.capacity}; {common.device_info(dev)['name']}", flush=True)

    def prep_bwd():
        m = gm.means.detach().requires_grad_(True)
        with torch.enable_grad():
            p = preprocess(m, *rest)
            return torch.autograd.grad(p.mean2d.sum() + p.conic.sum(), m)

    def pack_bwd():
        m2 = prep.mean2d.detach().requires_grad_(True)
        with torch.enable_grad():
            p = dataclasses.replace(prep, mean2d=m2)
            return torch.autograd.grad((pack_instances(p, bins, aux) ** 2).sum(), m2)

    def full():
        m = gm.means.detach().requires_grad_(True)
        with torch.enable_grad():
            p = preprocess(m, *rest)
            o = blend_and_untile(pack_instances(p, bins, aux), bins.counts, cam, cfg)
            return torch.autograd.grad(o.color.abs().sum() + o.depth.sum() + o.alpha.sum(), m)

    pieces = {
        "preprocess fwd": lambda: preprocess(gm.means, *rest),
        "preprocess fwd+bwd": prep_bwd,
        "pack (from a fixed projection)": lambda: pack_instances(prep, bins),
        "pack fwd+bwd (sorted backward)": pack_bwd,
        "blend fwd (K3)": lambda: blend_forward(packed, bins.counts, cam, cfg),
        "full raster iteration (d/dmeans)": full,
    }
    res = {**common.device_info(dev), "instances": int(bins.counts.sum()), "ms": {}}
    for name, fn in pieces.items():
        with torch.no_grad():
            ms = common.wall_ms(fn, dev, reps=args.reps)
        res["ms"][name] = ms
        common.report(name, ms)
    return res


if __name__ == "__main__":
    main()
