"""The raster hot path piece by piece (counterpart of
``scripts/profile_raster.py``).

At the bench scene with that script's view (tile 16, capacity 1024, chunk
256, dilate 2 px), at the identity pose:

    preprocess                 the per-Gaussian projection
    preprocess + bin           and the tile binning (sort, tile counts)
    preprocess + pack          and the per-tile pack gather [T, 16, cap]
    pack fwd+bwd               the gather and its sorted backward from the
                               projection (d/dmeans)
    K2f                        the per-instance projection of the raw pack
    K2f + K2b                  and its pose adjoint (autograd, d/dpose)
    K3 blend-and-untile        the forward render
    K3 + K6                    and its backward
    K1                         one tracking loss-grad on the pack
    K2f -> K1 -> K2b           a whole tracking iteration's pose gradient

The TPU script's primitive and matmul probes measure the TPU's units and
are not carried over; ``profile_gather`` compares the gathers and scatters
at the mapping path's shapes.

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_raster [--cpu]``.
"""

from __future__ import annotations

import argparse

import torch

from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.core.transforms import matrix_to_pose
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_and_untile,
    pack_instances,
    tile_gt_images,
    tile_pack_grad_aux,
    tracking_loss_grad,
)
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel


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
                       dilate_px=2.0, exact_stop=False)
    tcfg = TrackingConfig()
    T = torch.eye(4, device=dev)
    params = common.map_params(gm)
    rest = params[1:] + (T, cam)
    with torch.no_grad():
        prep = preprocess(*params, T, cam)
        bins = bin_gaussians(prep, cam, cfg)
        packed = pack_instances(prep, bins)
        raw = pack_raw_instances(*params, bins)
        gt4 = tile_gt_images(*common.gt_images(gm, T, cam, cfg), cam, cfg)
    aux = tile_pack_grad_aux(bins, gm.capacity)
    rt = rt_from_matrix(T).contiguous()
    quat, trans = matrix_to_pose(T)
    print(f"# instances {int(bins.counts.sum())}, tiles {bins.indices.shape[0]}, capacity "
          f"{args.capacity}, chunk {cfg.chunk}; {common.device_info(dev)['name']}", flush=True)

    def pack_bwd():
        m = gm.means.detach().requires_grad_(True)
        with torch.enable_grad():
            pk = pack_instances(preprocess(m, *rest), bins, aux)
            return torch.autograd.grad((pk ** 2).sum(), m)

    def k2_bwd():
        r = rt.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad((preprocess_instances_kernel(raw, r, cam) ** 2).sum(), r)

    def blend_bwd():
        p = packed.detach().requires_grad_(True)
        with torch.enable_grad():
            o = blend_and_untile(p, bins.counts, cam, cfg)
            return torch.autograd.grad(o.color.abs().sum() + o.depth.sum() + o.alpha.sum(), p)

    w = (tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth)
    pieces = {
        "preprocess": lambda: preprocess(*params, T, cam),
        "preprocess + bin": lambda: bin_gaussians(preprocess(*params, T, cam), cam, cfg),
        "preprocess + pack": lambda: pack_instances(preprocess(*params, T, cam), bins),
        "pack fwd+bwd (d/dmeans)": pack_bwd,
        "K2f (instance projection)": lambda: preprocess_instances_kernel(raw, rt, cam),
        "K2f + K2b (d/dpose)": k2_bwd,
        "K3 blend-and-untile": lambda: blend_and_untile(packed, bins.counts, cam, cfg),
        "K3 + K6 (d/dpacked)": blend_bwd,
        "K1 tracking loss-grad": lambda: tracking_loss_grad(packed, bins.counts, gt4, cam, cfg,
                                                            *w),
        "K2f -> K1 -> K2b (pose gradient)": lambda: common.pose_value_and_grad(
            raw, bins.counts, gt4, cam, cfg, tcfg, quat, trans),
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
