"""Where K1's time goes: K9's ablation variants on the tracking view's pack
(counterpart of ``scripts/profile_fused_ablate.py``).

K9 is K1's iteration over exactly ``ABLATE_CHUNKS`` = 2 chunks per tile
(counts ignored, no transmittance stop), so every variant evaluates the same
(pixel, instance) pairs; the variants switch parts off and the time is
attributed by difference:

    full      K1's math over the fixed walk
    fwd       the forward and the loss rows only (no backward)
    noexp     each exponential replaced by an FMA (timing only)
    noreduce  each per-instance sum over a tile's pixels replaced by one
              lane's value (timing only)
    min       noexp and noreduce together (timing only)
    half2     the forward falloff and alpha of two instances per step in
              __half2 (timing only)

The TPU script's ``nomxu`` (its matrix-unit contractions) becomes
``noreduce`` here, the only contraction of the per-pixel loop, and its two
bf16 variants become ``half2``. Beside the variants it prints K1's time on
the same pack and the pairs each evaluates.

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_fused_ablate
[--capacity 512] [--chunk 256] [--variants full,fwd,...] [--cpu]``; the
reference's view is ``--capacity 1024 --chunk 128``. On the CPU only
``full`` and ``fwd`` run (their plain version); the timing-only variants
raise there.
"""

from __future__ import annotations

import argparse
import json

import torch

from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    ABLATE_CHUNKS,
    ABLATE_VARIANTS,
    ablate_view,
    pack_instances,
    tile_gt_images,
    tracking_blend,
    tracking_loss_grad,
    tracking_loss_grad_ablate,
)
from gsorb_slam_tpu_torch.raster.types import RasterConfig


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--capacity", type=int, default=512, help="tile capacity of the pack")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default every variant on the card, full,fwd on the CPU")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed run")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    variants = (args.variants.split(",") if args.variants
                else list(ABLATE_VARIANTS) if dev.type == "cuda" else ["full", "fwd"])

    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    cfg = RasterConfig(tile=16, tile_capacity=args.capacity, max_dup=16, chunk=args.chunk,
                       dilate_px=2.0, exact_stop=False)
    tcfg = TrackingConfig()
    w = (tcfg.im_weight, tcfg.depth_weight, tcfg.use_sur_depth)
    T_id = torch.eye(4, device=dev)
    with torch.no_grad():
        prep = preprocess(*common.map_params(gm), T_id, cam)
        bins = bin_gaussians(prep, cam, cfg)
        packed = pack_instances(prep, bins)
        gt4 = tile_gt_images(*common.gt_images(gm, T_id, cam, cfg), cam, cfg)
        view, counts_f = ablate_view(packed, cfg)
        k9_pairs, k1_pairs = {}, {}
        tracking_blend(view, counts_f, cam, cfg, pairs=k9_pairs, stop=False)
        tracking_blend(packed, bins.counts, cam, cfg, pairs=k1_pairs)
    n_tiles, _, cap = packed.shape
    units = n_tiles * ABLATE_CHUNKS
    # The least time for "full" and "fwd": they read the ten blend rows of
    # every walked slot and the gt tiles and write the whole gradient block
    # (zeros past the walk; all zeros for fwd); full walks the slots its
    # warps applied twice, fwd once (common.blend_ops).
    n_bytes = (n_tiles * 10 * view.shape[2] + gt4.numel() + n_tiles * 16 * cap) * 4
    bounds = {
        "full": common.bound_ms(n_bytes, common.blend_ops(k9_pairs, 2, (
            common.BLEND_APPLY_OPS_PER_PAIR + common.TRACK_BWD_APPLY_OPS_PER_PAIR))),
        "fwd": common.bound_ms(n_bytes, common.blend_ops(k9_pairs, 1,
                                                         common.BLEND_APPLY_OPS_PER_PAIR)),
    }
    print(f"# K9: {ABLATE_CHUNKS} chunks of {cfg.chunk} per tile over {n_tiles} tiles "
          f"({units} chunk-units), capacity {args.capacity}; pairs {json.dumps(k9_pairs)}; "
          f"K1 on the same pack: {json.dumps(k1_pairs)}; {common.device_info(dev)['name']}",
          flush=True)

    res = {**common.device_info(dev), "tiles": n_tiles, "fixed_chunks": ABLATE_CHUNKS,
           "chunk": cfg.chunk, "capacity": args.capacity, "chunk_units": units,
           "pairs": {"k9": k9_pairs, "k1": k1_pairs}, "variants": {},
           "bound_ms": {v: {"ms": b, "by": by} for v, (b, by) in bounds.items()}}
    with torch.no_grad():
        for v in variants:
            ms = common.time_ms(
                lambda v=v: tracking_loss_grad_ablate(packed, gt4, cam, cfg, *w, variant=v),
                dev, args.reps)
            res["variants"][v] = {"ms": ms, "us_per_chunk_unit": ms * 1e3 / units}
            b = (f", bound {bounds[v][0]:.4f} ms by {bounds[v][1]}" if v in bounds else "")
            common.report(f"K9 {v}", ms, f"({ms * 1e3 / units:.4f} us/chunk-unit{b})")
        res["k1_ms"] = common.time_ms(
            lambda: tracking_loss_grad(packed, bins.counts, gt4, cam, cfg, *w), dev, args.reps)
    common.report("K1 on the same pack (its stops, its counts)", res["k1_ms"])
    t = {v: r["ms"] for v, r in res["variants"].items()}
    if "full" in t:
        for part, v in (("backward", "fwd"), ("exponentials", "noexp"),
                        ("per-instance pixel sums", "noreduce"), ("exp + sums", "min"),
                        ("f32 falloff vs half2", "half2")):
            if v in t:
                res.setdefault("attributed_ms", {})[part] = t["full"] - t[v]
                common.report(f"  full - {v} ({part})", t["full"] - t[v])
    return res


if __name__ == "__main__":
    main()
