"""The (pixel, instance) pairs the blend kernels work on at the bench scene,
counted by the plain blend (``blend_kernels.blend_tiles``), a batch of tiles
at a time so that the full view fits in little memory on the CPU.

For each pack it prints the pair counts the kernels' bounds charge
(``evaluated``, ``applied``, ``to_last``), ``warp_visits``: the (lane,
slot) pairs a backward evaluates when each warp (32 consecutive pixels)
visits only the slots one of its lanes applied, against ``to_last``, the
pairs a walk to each pixel's last applied slot evaluates, and
``warp_kept``: the (lane, slot) pairs a forward evaluates when each warp
walks only the slots whose footprint box meets its pixels (K4's cull,
``blend_kernels.footprint_keep``), against ``evaluated``. The packs are
``chip_smoke.py``'s: the tracking view at a pose 1 cm off (K1, K7), the
paired 16x8 view (K8, per tile half) and the render bins (K3 / K6; the
flat mapping blend K4 / K5 walks the same tiles in the same order). The
counts depend on the data only, not on the device.

Usage: ``python -m gsorb_slam_tpu_torch.profiling.count_pairs [--cpu]
[--tile-batch 40]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from gsorb_slam_tpu_torch.core.transforms import pose_to_matrix
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.binning import tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import blend_tiles, pack_instances, tile_pixels
from gsorb_slam_tpu_torch.raster.instances import pack_raw_instances, rt_from_matrix
from gsorb_slam_tpu_torch.raster.paired import pair_bins, tracking_pair_order
from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel
from gsorb_slam_tpu_torch.slam.tracking import tracking_raster_config

KEYS = ("evaluated", "applied", "to_last", "warp_visits", "warp_kept")


def pair_counts(packed, counts, tile_ids, cam, cfg, crossing_median, batch) -> dict:
    """``blend_tiles``'s pair counts over every tile, ``batch`` tiles at a time."""
    _, tx = tile_grid_shape(cam, cfg)
    total = dict.fromkeys(KEYS, 0)
    for s in range(0, packed.shape[0], batch):
        sl = slice(s, s + batch)
        pu, pv = tile_pixels(tile_ids[sl], tx, cfg.tile_w_px, cfg.tile_h_px)
        pairs = {}
        blend_tiles(packed[sl], counts[sl], pu, pv, min(cfg.chunk, packed.shape[2]),
                    cfg.exact_stop, crossing_median, pairs)
        for k in KEYS:
            total[k] += pairs[k]
    return total


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--tile-batch", type=int, default=40, help="tiles blended at a time")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    rcfg = common.bench_raster_config()
    rcfg_t = tracking_raster_config(rcfg)
    rcfg_p = tracking_raster_config(dataclasses.replace(rcfg, paired=True))
    params = common.map_params(gm)
    rt1 = rt_from_matrix(pose_to_matrix(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                                        torch.tensor([0.01, 0.0, 0.0], device=dev))).contiguous()
    res = {**common.device_info(dev)}
    with torch.no_grad():
        prep = preprocess(*params, torch.eye(4, device=dev), cam)
        packs = {}
        bins_t = bin_gaussians(prep, cam, rcfg_t)
        screen = preprocess_instances_kernel(pack_raw_instances(*params, bins_t), rt1, cam)
        ids = torch.arange(bins_t.counts.numel(), dtype=torch.int32, device=dev)
        packs["K1"] = (screen, bins_t.counts, ids, rcfg_t, True)
        packs["K7"] = (screen, bins_t.counts, ids, dataclasses.replace(rcfg_t, exact_stop=True),
                       False)
        bins_p0 = bin_gaussians(prep, cam, rcfg_p)
        perm = tracking_pair_order(bins_p0, cam, rcfg_p)
        bins_p = pair_bins(bins_p0, perm)
        screen_p = preprocess_instances_kernel(pack_raw_instances(*params, bins_p), rt1, cam)
        packs["K8"] = (screen_p, bins_p.counts, perm, rcfg_p, True)
        bins_r = bin_gaussians(prep, cam, rcfg)
        ids_r = torch.arange(bins_r.counts.numel(), dtype=torch.int32, device=dev)
        packs["K3 / K6 (render bins)"] = (pack_instances(prep, bins_r), bins_r.counts, ids_r,
                                          rcfg, False)
        for name, (pk, cnt, tid, cfg, crossing) in packs.items():
            res[name] = pair_counts(pk, cnt, tid, cam, cfg, crossing, args.tile_batch)
            r = res[name]
            print(f"# {name}: {json.dumps(r)}; warp_visits / to_last "
                  f"{r['warp_visits'] / max(r['to_last'], 1):.4f}, warp_kept / evaluated "
                  f"{r['warp_kept'] / max(r['evaluated'], 1):.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
